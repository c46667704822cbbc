"""mamba2-130m [arXiv:2405.21060].

24L d_model=768 attention-free, ssm_state=128, vocab=50280 — SSD
(state-space duality): chunked prefill, an O(1) recurrent decode state.
"""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, head_dim=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_expand=2, ssm_headdim=64,
    ssm_ngroups=1, ssm_chunk=256,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, head_dim=0, d_ff=0,
    vocab=512, vocab_pad_multiple=64, ssm_state=16, ssm_expand=2,
    ssm_headdim=16, ssm_ngroups=1, ssm_chunk=16, uq_samples=3,
)
