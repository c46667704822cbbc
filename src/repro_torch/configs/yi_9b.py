"""yi-9b [arXiv:2403.04652; hf-verified].

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 — llama-arch GQA.
"""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab=64000, rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="yi-9b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, vocab_pad_multiple=64, uq_samples=3,
)
