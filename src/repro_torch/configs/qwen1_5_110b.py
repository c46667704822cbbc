"""qwen1.5-110b [hf:Qwen/Qwen1.5-110B; hf-verified].

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064, QKV bias.
The largest dense arch (110B): FSDP(data) × TP(model) sharding.
"""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=49152, vocab=152064, qkv_bias=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen1.5-110b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, vocab_pad_multiple=64, qkv_bias=True, uq_samples=3,
)
