"""Architecture config registry of the port: ``--arch <id>`` resolution
(port of ``repro/configs/__init__.py``) over the four dense
architectures, the two MoE ones, the SSM (mamba2-130m) and the hybrid
(zamba2-2.7b).  The others of the reference raise
``NotImplementedError`` naming their ROADMAP item; the reference's
dry-run shape grid (``shapes.py``) waits for the LM trainer (A14)."""

from repro_torch.configs import (mamba2_130m, mixtral_8x7b, qwen1_5_110b,
                                 qwen3_0_6b, qwen3_1_7b, qwen3_moe_235b_a22b,
                                 yi_9b, zamba2_2_7b)

_MODULES = {
    "qwen3-0.6b": qwen3_0_6b,
    "qwen1.5-110b": qwen1_5_110b,
    "yi-9b": yi_9b,
    "qwen3-1.7b": qwen3_1_7b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b,
    "mixtral-8x7b": mixtral_8x7b,
    "mamba2-130m": mamba2_130m,
    "zamba2-2.7b": zamba2_2_7b,
}

_WAITING = {
    "whisper-medium": "A13.3: audio",
    "llama-3.2-vision-11b": "A13.3: VLM",
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False):
    if arch in _WAITING:
        raise NotImplementedError(
            f"{arch} is not ported yet (ROADMAP {_WAITING[arch]})")
    mod = _MODULES[arch]
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ARCHS", "get_config"]
