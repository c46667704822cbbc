"""llama-3.2-vision-11b [hf:meta-llama/Llama-3.2-11B-Vision].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; every 5th
layer is a dedicated cross-attention layer (with its own MLP, llama-3.2
style) reading stubbed image patch embeddings [B, 1601, d_model].
"""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128256, rope_theta=5e5,
    cross_attn_every=5, n_image_tokens=1601,
)

SMOKE = ModelConfig(
    name="llama-vision-smoke", family="vlm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, vocab_pad_multiple=64,
    cross_attn_every=2, n_image_tokens=18, uq_samples=3,
)
