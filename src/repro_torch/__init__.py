"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
tree module for module so that a reader finds each counterpart at the
same path.  It imports ``torch`` and never ``jax``.  Every Pallas kernel
of the reference becomes a kernel written by hand for Hopper under
``kernels/csrc``; its plain PyTorch version sits beside it and serves
CPU tensors (the tests), while CUDA tensors always go through the
kernel.

Ported so far: SAR triage serving (``launch.serve.serve_sar`` →
``serving.engine.SarServingEngine``) on the ideal die and on a sampled
chip instance (``hw/``), with two kernels: the fused decision update
(``kernels/decision.py``) and the chunked-ADC CIM product of the conv
trunk on a die (``kernels/cim.py``).

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``): ``resolve_device(None)`` is ``"cuda"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device a port entry point runs on: ``None`` means the card.

    Raises when CUDA is asked for and absent — no path falls back to
    the CPU silently; pass ``device="cpu"`` to run there on purpose.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev
