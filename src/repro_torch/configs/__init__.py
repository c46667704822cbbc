"""Architecture config registry of the port: ``--arch <id>`` resolution
(port of ``repro/configs/__init__.py``) over the four dense
architectures.  The others of the reference raise
``NotImplementedError`` naming their ROADMAP item; the reference's
dry-run shape grid (``shapes.py``) waits for the LM trainer (A14)."""

from repro_torch.configs import qwen1_5_110b, qwen3_0_6b, qwen3_1_7b, yi_9b

_MODULES = {
    "qwen3-0.6b": qwen3_0_6b,
    "qwen1.5-110b": qwen1_5_110b,
    "yi-9b": yi_9b,
    "qwen3-1.7b": qwen3_1_7b,
}

_WAITING = {
    "qwen3-moe-235b-a22b": "MoE",
    "mixtral-8x7b": "MoE and the rolling cache",
    "mamba2-130m": "SSM/hybrid",
    "zamba2-2.7b": "SSM/hybrid",
    "whisper-medium": "audio",
    "llama-3.2-vision-11b": "VLM",
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False):
    if arch in _WAITING:
        raise NotImplementedError(
            f"{arch} is not ported yet (ROADMAP A13: {_WAITING[arch]})")
    mod = _MODULES[arch]
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ARCHS", "get_config"]
