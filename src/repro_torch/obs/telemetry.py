"""Device-resident serving telemetry (port of ``repro/obs/telemetry.py``).

The engines make one blocking device→host pull a dispatch (serving) or
a die group (mission).  A host callback or an extra pull a round would
destroy exactly that, so telemetry lives ON the device: a dict of int32
counters and histograms and float32 GRNG sample moments, updated in
place by each round and crossing to the host only where the caller
already syncs (``snapshot``, the module's one sync, or the mission's
packed pull).

  rounds / dispatches / samples     scalar int32 counters
  verdicts[3]                       ACCEPT / ESCALATE / FLAG at retire
  r_hist[r_max+1]                   samples-at-verdict histogram
  conf_hist / ent_hist / mi_hist    decision-quality histograms
  grng_n, grng_sum, grng_sumsq      the Fig. 9 probe's moments
  ent_max                           log(n_classes), for the edges

The GRNG probe re-reads the raw 16-cell array sums of a fixed block of
``probe_cells`` cells (rows 0…P−1, column 0) under each round's own
selections and stream indices: the measurement ``hw/calib.measured_grng``
makes at calibration time, riding the serving stream, so ``obs/drift``
can z-test the deployment against its belief.

Every update is masked arithmetic: a round whose mask is all False
(the engine's rounds after the exit, the mission's orbit when nothing
is flagged) adds exactly 0, so the counts equal the reference's, whose
loops never run those rounds.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch

from repro_torch import float32_math
from repro_torch.core import clt_grng

Telemetry = dict[str, torch.Tensor]

_MOMENTS = ("grng_n", "grng_sum", "grng_sumsq")


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Static telemetry shape.

    probe_cells: cells re-read per round for the GRNG moments (0 turns
                 the probe off; counters and histograms remain).
    conf_bins:   confidence histogram bins over [0, 1].
    ent_bins:    entropy and mutual-information bins over [0, ln K].
    """

    probe_cells: int = 32
    conf_bins: int = 16
    ent_bins: int = 16


def init_telemetry(tcfg: TelemetryConfig, r_max: int,
                   device=None) -> Telemetry:
    """Zeroed telemetry for a policy with ``r_max`` samples at most, on
    ``device`` (None: the card)."""
    from repro_torch import resolve_device
    dev = resolve_device(device)

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {"rounds": z(), "dispatches": z(), "samples": z(),
            "verdicts": z(3), "r_hist": z(int(r_max) + 1),
            "conf_hist": z(tcfg.conf_bins), "ent_hist": z(tcfg.ent_bins),
            "mi_hist": z(tcfg.ent_bins),
            "grng_n": z(dtype=torch.float32),
            "grng_sum": z(dtype=torch.float32),
            "grng_sumsq": z(dtype=torch.float32),
            "ent_max": z(dtype=torch.float32)}


@functools.lru_cache(maxsize=64)
def _probe_currents(grng_cfg, probe_cells: int,
                    device: torch.device) -> torch.Tensor:
    """The probe block's device currents [P, 16]: a function of the
    config alone, so hashed once per (config, device) and not in every
    round (read only; the cache holds a few small tensors)."""
    rows = torch.arange(probe_cells, dtype=torch.int64, device=device)
    return clt_grng.device_currents(grng_cfg, rows, torch.zeros_like(rows))


def _probe_raw(tcfg: TelemetryConfig, grng_cfg, sel: torch.Tensor,
               sample_idx: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
    """Raw 16-cell sums [r, probe_cells] (µA) of the probe block for one
    lane: its selections ``sel`` [r, B, 16] and absolute stream indices
    ``sample_idx`` [r, B] (uint32 in int64), which the round has already
    made; ``lane`` is a 0-dim device index."""
    p = tcfg.probe_cells
    currents = _probe_currents(grng_cfg, p, sel.device)
    sel_lane = sel.index_select(1, lane.reshape(1))[:, 0].to(torch.float32)
    with float32_math():
        raw = sel_lane @ currents.T                          # [r, P]
    if grng_cfg.read_sigma > 0.0:
        rows = torch.arange(p, dtype=torch.int64, device=sel.device)
        idx_lane = sample_idx.index_select(1, lane.reshape(1))  # [r, 1]
        raw = raw + clt_grng.read_noise_at(
            grng_cfg, rows[None, :], torch.zeros_like(rows)[None, :],
            idx_lane)
    return raw


def record_round(telem: Telemetry, tcfg: TelemetryConfig, grng_cfg,
                 sel: torch.Tensor, sample_idx: torch.Tensor,
                 upd: torch.Tensor) -> Telemetry:
    """Fold one decision round into ``telem`` in place (no sync) and
    return it.

    ``upd`` [B] marks the slots whose statistics this round advances:
    the mask the round really updated.  The probe follows the first
    updating lane (an inactive lane's stream stands still, and re-reading
    it would repeat selections); with no lane updating the weight is 0
    and nothing moves."""
    r = sel.shape[0]
    any_upd = upd.any()
    telem["rounds"].add_(any_upd.to(torch.int32))
    telem["samples"].add_(r * upd.to(torch.int32).sum(dtype=torch.int32))
    if tcfg.probe_cells > 0:
        # torch.argmax of a bool tensor is not defined: take the first
        # maximum of its int32 cast
        lane = upd.to(torch.int32).argmax()
        raw = _probe_raw(tcfg, grng_cfg, sel, sample_idx, lane)
        w = any_upd.to(torch.float32)
        telem["grng_n"].add_(w * raw.numel())
        telem["grng_sum"].add_(w * raw.sum())
        telem["grng_sumsq"].add_(w * (raw * raw).sum())
    return telem


def _bins(x: torch.Tensor, bins: int) -> torch.Tensor:
    """Histogram bin of each value x · bins (x in [0, 1]), truncated and
    clipped to [0, bins − 1]."""
    return (x * bins).to(torch.int32).clamp(0, bins - 1).long()


def record_decisions(telem: Telemetry, tcfg: TelemetryConfig, fin: dict,
                     verdict: torch.Tensor,
                     decided: torch.Tensor) -> Telemetry:
    """Fold retiring decisions into the verdict, R and quality
    histograms, in place.  ``decided`` [B] masks the slots whose verdict
    is final: each decision is recorded exactly once."""
    di = decided.to(torch.int32)
    dev = di.device
    n_classes = fin["probs"].shape[-1]
    ent_max = float(np.log(max(n_classes, 2)))
    # a true division by a float32 tensor: a Python scalar divisor may
    # become a product with its reciprocal on the card
    ent_t = torch.full((), ent_max, dtype=torch.float32, device=dev)
    telem["verdicts"].index_add_(0, verdict.clamp(0, 2).long(), di)
    telem["r_hist"].index_add_(
        0, fin["n"].clamp(0, telem["r_hist"].shape[0] - 1).long(), di)
    telem["conf_hist"].index_add_(
        0, _bins(fin["confidence"], tcfg.conf_bins), di)
    telem["ent_hist"].index_add_(
        0, _bins(fin["predictive_entropy"] / ent_t, tcfg.ent_bins), di)
    telem["mi_hist"].index_add_(
        0, _bins(fin["mutual_information"] / ent_t, tcfg.ent_bins), di)
    torch.maximum(telem["ent_max"], ent_t, out=telem["ent_max"])
    return telem


def count_dispatch(telem: Telemetry,
                   ran: torch.Tensor | None = None) -> Telemetry:
    """Count one engine dispatch, in place.  ``ran``: a device bool, for
    a dispatch the reference would have skipped when it is False (the
    mission's orbit under ``lax.cond``); None counts unconditionally."""
    telem["dispatches"].add_(1 if ran is None else ran.to(torch.int32))
    return telem


def _host(telem) -> dict[str, np.ndarray]:
    """Telemetry leaves on the host, in ONE transfer when they are
    device tensors (float64 holds int32 and float32 values exactly);
    leaves already pulled pass through."""
    if not isinstance(next(iter(telem.values())), torch.Tensor):
        return {k: np.asarray(v) for k, v in telem.items()}
    packed = torch.cat([v.reshape(-1).to(torch.float64)
                        for v in telem.values()]).cpu().numpy()
    out, off = {}, 0
    for k, v in telem.items():
        out[k] = packed[off:off + v.numel()].reshape(v.shape)
        off += v.numel()
    return out


def snapshot(telem, tcfg: TelemetryConfig) -> dict[str, Any]:
    """``telem`` on the host with its summary statistics: the module's
    only host sync (none when the leaves were already pulled, as the
    mission's packed pull does).  Plain Python and lists, JSON-ready; the
    raw GRNG moments stay beside the derived mean and SD so streaming
    monitors can keep folding snapshots."""
    host = _host(telem)
    n, g_sum, g_sumsq = (float(host[k]) for k in _MOMENTS)
    g_mean = g_sum / n if n > 0 else float("nan")
    if n > 1:
        var = (g_sumsq - n * g_mean * g_mean) / (n - 1.0)
        g_std = float(math.sqrt(max(var, 0.0)))
    else:
        g_std = float("nan")
    ent_max = float(host["ent_max"])
    if ent_max <= 0.0:
        ent_max = float("nan")
    verdicts = np.asarray(host["verdicts"]).astype(np.int64)

    def ints(k):
        return np.asarray(host[k]).astype(int).tolist()

    return {
        "rounds": int(host["rounds"]),
        "dispatches": int(host["dispatches"]),
        "samples": int(host["samples"]),
        "decisions": int(verdicts.sum()),
        "verdicts": {"accept": int(verdicts[0]),
                     "escalate": int(verdicts[1]),
                     "flag": int(verdicts[2])},
        "r_hist": ints("r_hist"),
        "conf_hist": ints("conf_hist"),
        "conf_edges": np.linspace(0.0, 1.0, tcfg.conf_bins + 1).tolist(),
        "ent_hist": ints("ent_hist"),
        "mi_hist": ints("mi_hist"),
        "ent_edges": (np.linspace(0.0, 1.0, tcfg.ent_bins + 1)
                      * (ent_max if np.isfinite(ent_max) else 1.0)).tolist(),
        "ent_max": ent_max,
        "grng": {"probe_cells": tcfg.probe_cells, "n": n, "sum": g_sum,
                 "sumsq": g_sumsq, "sum_mean_uA": g_mean,
                 "sum_std_uA": g_std},
    }


def merge_snapshots(snaps: list[dict[str, Any]]) -> dict[str, Any]:
    """Combine host snapshots of several engines or groups of one die."""
    if not snaps:
        return {}
    out = dict(snaps[0])
    for s in snaps[1:]:
        for k in ("rounds", "dispatches", "samples", "decisions"):
            out[k] = out[k] + s[k]
        out["verdicts"] = {k: out["verdicts"][k] + s["verdicts"][k]
                           for k in out["verdicts"]}
        for k in ("r_hist", "conf_hist", "ent_hist", "mi_hist"):
            a, b = out[k], s[k]
            if len(a) < len(b):
                a = a + [0] * (len(b) - len(a))
            out[k] = [x + (b[i] if i < len(b) else 0)
                      for i, x in enumerate(a)]
        g, h = out["grng"], s["grng"]
        out["grng"] = dict(g)
        for k in ("n", "sum", "sumsq"):
            out["grng"][k] = g[k] + h[k]
    g = out["grng"]
    n = g["n"]
    if n > 1:
        mean = g["sum"] / n
        var = (g["sumsq"] - n * mean * mean) / (n - 1.0)
        out["grng"]["sum_mean_uA"] = mean
        out["grng"]["sum_std_uA"] = float(math.sqrt(max(var, 0.0)))
    return out
