"""qwen3-0.6b [hf:Qwen/Qwen3-0.6B; hf-verified].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936, qk-norm.
"""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=3072, vocab=151936, qk_norm=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen3-0.6b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, vocab_pad_multiple=64, qk_norm=True, uq_samples=3,
)
