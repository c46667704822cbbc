"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-235B-A22B family; hf-verified].

94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936,
MoE 128 experts top-8, qk-norm.
"""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936, qk_norm=True, rope_theta=1e6,
    n_experts=128, top_k=8,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab=512, vocab_pad_multiple=64, qk_norm=True,
    n_experts=8, top_k=2, uq_samples=3,
)
