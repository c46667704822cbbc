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
trunk on a die (``kernels/cim.py``); fixed-R sampling of the Bayesian
head and its UQ report (``models.sar_cnn.logit_samples_serve``,
``core.sampling.logit_samples``, ``core.uncertainty``), with the fused
head kernels in rank16 and paper mode (``kernels/bayes.py``), and the
GRNG ε block (``kernels/grng.py``).

Training: ``mission.detector.trained_detector`` trains the SAR
detector by Bayes-by-backprop (``models.sar_cnn.train_loss``,
``optim.adamw``), each step's head draw through the ε kernel, and
caches it (``ckpt``).

The closed-loop mission: ``mission.fly_mission`` (and
``launch.mission``) flies a fleet over grid worlds rendered on the
device, deciding every step through ``serving.engine.token_decision``
(the decision kernel) and, on a die, the CIM trunk, with one host pull
per die group.

Observability and lifetime: device-resident telemetry (``obs.
telemetry``, on by default in the engine, ``serve_sar`` and the
mission), drift watch against the deployment's belief (``obs.drift``),
dies that age in the field (``hw.aging``, ``ChipInstance.at_age``) and
recalibrate-and-redeploy (``hw.redeploy``; ``launch.serve.
serve_sar_lifetime``, ``fly_mission(lifetime=...)``).

The dense language models: ``launch.serve.serve(arch, smoke=...)``
serves qwen3-0.6b, qwen3-1.7b, yi-9b or qwen1.5-110b (``configs``)
through ``serving.LMServingEngine`` over ``models.transformer``, each
token decided at vocabulary width through the decision kernel.

The LM trainer: ``launch.train.train`` (and ``python -m
repro_torch.launch.train``) trains any LM family through
``launch.steps.make_train_step`` (every family's ``train_loss``, remat,
AdamW with optional master weights, microbatches), each step's head
draw at vocabulary width through the ε kernel, with asynchronous
checkpoints, resume, gradient compression and a straggler monitor.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``): ``resolve_device(None)`` is ``"cuda"``.  Float32
convolutions and matrix products run in float32 on the card
(``float32_math``), not in the TF32 PyTorch gives cuDNN by default, and
bfloat16 products reduce in float32.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float32_math(deterministic: bool = False):
    """Float32 convolutions and matrix products in full float32 for the
    duration of the block: cuDNN and cuBLAS without TF32 (PyTorch lets
    cuDNN take TF32, a 10-bit mantissa, for float32 convolutions by
    default), and bfloat16 products reduced in float32 (cuBLAS may
    otherwise reduce split-K partial sums in bfloat16).
    ``deterministic`` also makes cuDNN choose deterministic algorithms
    (no atomics in the backward convolutions).  The process's settings
    are restored on exit; none is changed at import.
    """
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
             matmul.allow_bf16_reduced_precision_reduction)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    cudnn.deterministic = deterministic or saved[2]
    try:
        yield
    finally:
        (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
         matmul.allow_bf16_reduced_precision_reduction) = saved


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
