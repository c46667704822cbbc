"""mixtral-8x7b [arXiv:2401.04088; hf-verified].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8 experts
top-2, sliding-window attention (window 4096): decode takes the rolling
cache (``models/attention``).
"""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000, rope_theta=1e6, swa_window=4096,
    n_experts=8, top_k=2,
)

SMOKE = ModelConfig(
    name="mixtral-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, vocab_pad_multiple=64, swa_window=16,
    n_experts=4, top_k=2, uq_samples=3,
)
