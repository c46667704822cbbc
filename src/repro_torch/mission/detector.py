"""Mission detector: weather-augmented SAR CNN training and its cache
(port of ``repro/mission/detector.py``).

A detector trained on clean SARD is confidently wrong under heavy
weather, and no triage policy can filter what the model is sure about.
So the detector trains with the expected corruption in its
augmentation: each image gets its own severity ~ U(0, severity_hi)
through ``data/sard.corrupt``'s severity-field API, which makes the
weather an in-distribution ambiguity the Bayesian head can price.

Training is Bayes-by-backprop (``models/sar_cnn.train_loss``) with the
reference's AdamW (``optim/adamw``).  Each step draws the head's
weights once, ε through the GRNG ε kernel on the card (one launch a
step).  The step runs in float32 with deterministic cuDNN algorithms
(``float32_math``).  The loop reads nothing back from the card but its
metrics at the log points (every ``LOG_EVERY`` steps); batches are made
on the host, from generators keyed by the step, so the card's and the
CPU's runs see the same data, and reach the card by asynchronous copies
from pinned memory.

Parameters and the per-step metrics (``ce``, ``kl``, ``acc``) are
cached through ``ckpt`` under ``artifacts/mission/detector-…`` (or
``ckpt_dir``) and restored on every later call.
"""

from __future__ import annotations

import logging
from pathlib import Path

import torch

from repro_torch import float32_math, resolve_device
from repro_torch.ckpt import latest_step, restore, save
from repro_torch.data.sard import SardConfig, _generator, batch_at, corrupt
from repro_torch.models.sar_cnn import SarCnnConfig, init_sar_cnn, train_loss
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.utils.trees import leaves, tree_map, unflatten_like

log = logging.getLogger("repro_torch.mission.detector")

ART = Path("artifacts/mission")
TRAIN_STEPS = 1600
TRAIN_BATCH = 64
DATA_SEED = 7          # the repo's shared SARD training stream
LOG_EVERY = 400
OPT = AdamWConfig(lr=1e-3, weight_decay=0.01)
_WEATHER_KEY = 0xA06
METRICS = ("ce", "kl", "acc")


def training_batch(dcfg: SardConfig, step: int, corruption: str,
                   severity_hi: float, batch: int = TRAIN_BATCH) -> dict:
    """Step ``step``'s batch on the host: SARD ``batch_at(step)``, each
    image corrupted at its own severity ~ U(0, severity_hi) (drawn from a
    generator keyed on the step), weather keyed on the step too."""
    data = batch_at(dcfg, step, batch)
    sev = severity_hi * torch.rand(
        batch, generator=_generator(_WEATHER_KEY, step, 1))
    return {"images": corrupt(data["images"], (_WEATHER_KEY, step, 2), sev,
                              corruption),
            "labels": data["labels"].long()}


def _to_device(batch: dict, device: torch.device) -> dict:
    if device.type == "cpu":
        return batch
    return {k: v.pin_memory().to(device, non_blocking=True)
            for k, v in batch.items()}


def train_step(params, opt: dict, batch: dict, cfg: SarCnnConfig,
               step: int):
    """One Bayes-by-backprop step: gradients of ``train_loss`` at stream
    offset ``step``, then the AdamW update -> (params, opt, metrics).
    Functional, as the reference's jitted step: new tensors out."""
    params = tree_map(lambda p: p.detach().requires_grad_(), params)
    with float32_math(deterministic=True):
        loss, metrics = train_loss(params, batch, cfg, step)
        grads = torch.autograd.grad(loss, leaves(params))
    params, opt, _ = adamw_update(params, unflatten_like(params, grads), opt,
                                  OPT)
    return params, opt, metrics


def train_detector(cfg: SarCnnConfig, corruption: str = "snow",
                   severity_hi: float = 0.5, steps: int = TRAIN_STEPS,
                   device=None):
    """Train from ``init_sar_cnn`` (generator seeded 3) on ``device``
    (None = the card) -> (params, history {ce, kl, acc: [steps]} on the
    device)."""
    dev = resolve_device(device)
    dcfg = SardConfig(image_size=cfg.image_size, seed=DATA_SEED)
    params = init_sar_cnn(torch.Generator().manual_seed(3), cfg, device=dev)
    opt = init_opt_state(params)
    history = torch.zeros((steps, len(METRICS)), device=dev)
    for s in range(steps):
        batch = _to_device(training_batch(dcfg, s, corruption, severity_hi),
                           dev)
        params, opt, m = train_step(params, opt, batch, cfg, s)
        history[s] = torch.stack([m[k] for k in METRICS])
        if s % LOG_EVERY == 0:
            ce, _, acc = history[s].tolist()              # host sync
            log.info("step %d ce=%.4f acc=%.3f", s, ce, acc)
    return params, dict(zip(METRICS, history.unbind(1)))


def trained_detector(cfg: SarCnnConfig | None = None,
                     corruption: str = "snow", severity_hi: float = 0.5,
                     steps: int = TRAIN_STEPS, ckpt_dir: Path | None = None,
                     device=None):
    """(params, cfg): the weather-augmented Bayesian-head detector on
    ``device`` (None = the card; raises without one).

    Trains once (``train_detector``) and saves {"params", "history"} at
    step ``steps`` under ``ckpt_dir`` (default ``artifacts/mission/
    detector-<corruption>-h<severity_hi>-s<steps>``, a key that carries
    every training knob); every later call restores it.
    """
    cfg = cfg or SarCnnConfig()
    dev = resolve_device(device)
    ckpt_dir = Path(ckpt_dir) if ckpt_dir is not None else (
        ART / f"detector-{corruption}-h{severity_hi:g}-s{steps}")
    if latest_step(ckpt_dir) is not None:
        tree, _ = restore(ckpt_dir)
        return tree_map(lambda a: torch.as_tensor(a, device=dev),
                        tree["params"]), cfg
    params, history = train_detector(cfg, corruption, severity_hi, steps,
                                     device=dev)
    save(ckpt_dir, steps, {"params": params, "history": history})
    return params, cfg
