"""zamba2-2.7b [arXiv:2411.15242; hf-verified].

54L d_model=2560 hybrid: mamba2 trunk (ssm_state=64) with ONE shared
attention block (32H, kv=32, d_ff=10240) applied every 6 mamba layers
(9 sites, zamba2's parameter-shared global block with embedding skip);
each site keeps its own KV cache.
"""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab=32000, ssm_state=64, ssm_expand=2, ssm_headdim=64,
    ssm_ngroups=1, ssm_chunk=256, hybrid_attn_every=6,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512, vocab_pad_multiple=64, ssm_state=16,
    ssm_expand=2, ssm_headdim=16, ssm_ngroups=1, ssm_chunk=16,
    hybrid_attn_every=2, uq_samples=3,
)
