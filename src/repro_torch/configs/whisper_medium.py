"""whisper-medium [arXiv:2212.04356].

24L enc + 24L dec, d_model=1024 16H (kv=16, MHA) d_ff=4096 vocab=51865.
Enc-dec with LayerNorm/GELU, learned positions, no RoPE.  The conv
audio frontend is a stub: ``data/tokens.stub_frames`` supplies frame
embeddings [B, 1500, d_model].  The decoder's learned-position table
holds 448 rows; a decode position past it reads its last row, as the
reference's does.
"""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=51865, norm="ln", mlp="gelu", use_rope=False,
    learned_pos=448, encoder_layers=24, n_frames=1500,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512, vocab_pad_multiple=64, norm="ln", mlp="gelu",
    use_rope=False, learned_pos=64, encoder_layers=2, n_frames=24,
    uq_samples=3,
)
