#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; each prints a
JSON line):
  1. the card (name and power limit from nvidia-smi), torch and CUDA
     versions; TF32 is switched off for matmuls and convolutions;
  2. build every kernel from ``src/repro_torch/kernels/csrc`` with nvcc,
     one process per source, all started together;
  3. every kernel against its plain PyTorch version on the card:
     the decision kernel at the main path's shapes and at ragged /
     read-noise / shared-selection shapes (rtol 1e-5, atol 1e-5, as
     tests/test_decision_kernel.py); the CIM kernel at the three trunk
     shapes an admission of 32 slots gives on the gate die and at two
     ragged shapes, ideal and with the die's ADC front end (rtol 1e-4,
     atol 1e-4, as tests/test_kernels.py; an output off by more is an
     ADC code flipped by the order of the 64-term sum, counted and held
     to one LSB and to at most 1e-4 of the outputs); run-to-run bit
     identity for both, zero-variation CIM = ideal CIM bit for bit;
  4. the ideal-die main path: ``serve_sar`` on the card, 192 fog-mixed
     requests in 32 slots under TriagePolicy(0.7, 0.05, r_min=4,
     r_max=20), random full-width params from a seed; the kernel launch
     counts are zeroed just before and read just after.  The same stream
     through ``fused=False`` (no kernel) must give the same decisions,
     and so must an escalating policy (0.55, 0.05) and a CPU run of 64
     requests;
  5. the chip-instance main path: the same 192 requests served on the
     gate die ``sample_instances(11, 1, VariationSpec().scaled(2.0))``,
     calibrated: the conv trunk through the CIM kernel (3 launches per
     admission), the head on the die's degraded GRNG (the decision
     kernel's read-noise branch, one launch per round); counts zeroed
     just before and read just after.  ``fused=False`` must give the
     same decisions, the uncalibrated die must serve every request, and
     CPU runs of 64 requests must decide as the card does, under the
     main policy and under the escalating one (whose decisions differ
     in kind and depth); confidence and MI agree to 1e-5 unless the
     trunk flipped an ADC code between card and CPU on the batches the
     card admitted (counted), then to 1e-3;
  6. kernel timing at the main path's shapes: device time from CUDA
     graph replays and per-call time of eager calls (CUDA events), beside
     the plain version's and the card's byte/flop bound;
  7. last line: {"ok": true, "device": {...}}.
It imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_OPS_PER_S = 67e12             # H100 SXM, float32 outside tensor cores
TOL = dict(rtol=1e-5, atol=1e-5)
CIM_TOL = dict(rtol=1e-4, atol=1e-4)
STAT_KEYS = ("sum_p", "sum_psq", "sum_ent", "sum_entsq")
POLICY = dict(conf_threshold=0.7, mi_threshold=0.05, r_min=4, r_max=20)
STREAM = dict(n_slots=32, corrupt_frac=0.25, corruption="fog", seed=0)
# Card vs CPU on a chip instance: the trunk's 64-term sums and ADC full
# scale are reduced in another order on each, and where a partial sum
# sits on a half-code tie one 6-bit code flips by an LSB, which moves
# that request's confidence by up to ~1e-3 (tests/test_torch_cim.py
# counts such flips).  The trunk's flips between card and CPU are
# counted on the batches the card admitted: confidence and MI are held
# to this only when one is present, to TOL's atol otherwise; verdicts,
# predictions and sample counts must be equal either way.
CIM_CPU_ATOL = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# kernel cases
# ----------------------------------------------------------------------
def decision_case(b, n, r, *, read_sigma=0.0, shared_sel=False,
                  row_offset=0, k=64, seed=0):
    """Inputs of one decision round built by the port's own path (head
    deployment, activation basis, stream selections) on the card."""
    import torch
    from repro_torch.core.clt_grng import GRNGConfig
    from repro_torch.core.sampling import (BayesHeadConfig,
                                           activation_basis,
                                           prepare_serving_head)
    from repro_torch.serving import adaptive
    gen = torch.Generator().manual_seed(seed)
    grng = GRNGConfig(read_sigma=read_sigma)
    hcfg = BayesHeadConfig(mode="rank16", grng=grng,
                           compute_dtype=torch.float32, hoist_basis=True)
    mu = (torch.randn((k, n), generator=gen) * 0.3).cuda()
    sigma = torch.nn.functional.softplus(
        torch.randn((k, n), generator=gen) - 3).cuda() * 0.5
    x = torch.randn((b, k), generator=gen).cuda()
    ab = activation_basis(prepare_serving_head(mu, sigma, hcfg), x, hcfg)
    ab = {key: v.contiguous() for key, v in ab.items()}
    base = (torch.randint(0, 2**20, (b,), generator=gen) * 20).cuda()
    drawn = torch.randint(0, 4, (b,), generator=gen).cuda() * 4
    idx = adaptive.stream_indices(base, drawn, r)
    sel = adaptive.stream_selections(grng, base, drawn, r)
    if shared_sel:
        sel, idx = sel[:, 0].contiguous(), idx[:, 0].contiguous()
    mask = (torch.arange(b) % 2 == 0).cuda()
    rows = (torch.arange(b, dtype=torch.int64) + row_offset).cuda() \
        if row_offset else None
    return dict(y_mu=ab["y_mu"], x_sigma=ab["x_sigma"], m=ab["m"], sel=sel,
                cfg=grng, x_sigsq=ab.get("x_sigsq"), sample_idx=idx,
                mask=mask, rows=rows)


def run_kernel_checks() -> tuple[float, dict]:
    import torch
    from repro_torch.kernels.decision import (decision_stats,
                                              decision_stats_plain)
    cases = {
        "main_r4": dict(b=32, n=2, r=4),
        "main_r20": dict(b=32, n=2, r=20),
        "ragged_n300": dict(b=9, n=300, r=6),
        "read_noise_rows": dict(b=32, n=2, r=4, read_sigma=0.4,
                                row_offset=1000),
        "read_noise_ragged": dict(b=9, n=300, r=6, read_sigma=0.4,
                                  row_offset=77),
        "shared_sel_r64": dict(b=5, n=130, r=64, read_sigma=0.4,
                               shared_sel=True),
    }
    worst = 0.0
    inputs = {}
    for i, (name, spec) in enumerate(cases.items()):
        args = decision_case(seed=i, **spec)
        got = decision_stats(**args)
        want = decision_stats_plain(**args)
        torch.cuda.synchronize()
        err = max(float((got[k] - want[k]).abs().max()) for k in STAT_KEYS)
        for key in STAT_KEYS:
            check(torch.allclose(got[key], want[key], **TOL),
                  f"decision kernel != plain version: {name} {key}")
        masked = ~args["mask"]
        check(bool((got["sum_p"][masked] == 0).all()),
              f"masked slots advanced: {name}")
        again = decision_stats(**args)
        torch.cuda.synchronize()
        identical = all(torch.equal(got[k], again[k]) for k in STAT_KEYS)
        check(identical, f"two launches differ: {name}")
        worst = max(worst, err)
        inputs[name] = args
        emit({"kernel_check": "decision_stats", "case": name, **spec,
              "max_abs_err": err, "rtol": TOL["rtol"], "atol": TOL["atol"],
              "bit_identical_relaunch": identical})
    too_many = decision_case(b=4, n=2, r=65)
    try:
        decision_stats(**too_many)
    except ValueError:
        pass
    else:
        raise AssertionError("R=65 should be refused by the wrapper")
    return worst, inputs


def gate_die():
    """The die the chip-instance main path serves on."""
    from repro_torch.hw import VariationSpec, sample_instances
    return sample_instances(11, 1, VariationSpec().scaled(2.0))[0]


def cim_cases() -> dict:
    """CIM kernel operands on the card.  ``trunk<i>``: what conv layer i
    gives the kernel when the main path admits 32 slots on the gate die
    (the port's params, images and trunk arrays; K padded to 64).
    ``ragged_*``: random operands at the reference's ragged test shapes.
    Every case carries the gate die's column front end."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.core import quant as q
    from repro_torch.kernels.ops import measured_full_scale
    from repro_torch.launch.serve import make_sar_stream
    from repro_torch.models import sar_cnn
    cfg = sar_cnn.SarCnnConfig()
    params = sar_cnn.init_sar_cnn(torch.Generator().manual_seed(3), cfg,
                                  device="cuda")
    die = gate_die()
    trunk = sar_cnn.program_trunk(params, cfg, die)
    h = torch.as_tensor(np.stack(
        [r.payload for r in make_sar_stream(32, corrupt_frac=0.25)]),
        device="cuda")
    cases = {}
    for i, layer in enumerate(trunk):
        cols = sar_cnn._im2col(h, layer["k"], 2)
        d = cols.shape[-1]
        xq, _ = q.quantize_input(cols.reshape(-1, d), cfg.quant)
        xq = F.pad(xq, (0, layer["w"].shape[0] - d)).contiguous()
        cases[f"trunk{i}"] = dict(
            x=xq, w=layer["w"], fs=measured_full_scale(
                xq, layer["w"], cfg.quant).reshape(1),
            gain=layer["gain"], offset=layer["offset"])
        h = sar_cnn._cim_conv(h, layer, cfg)
    gen = torch.Generator().manual_seed(5)
    for m, k, n in ((130, 192, 257), (8, 192, 70)):
        x = torch.randn((m, k), generator=gen).cuda()
        w = (torch.randn((k, n), generator=gen) * 0.05).cuda()
        gain, off = die.adc_columns(n)
        cases[f"ragged_{m}x{k}x{n}"] = dict(
            x=x, w=w, fs=measured_full_scale(x, w, cfg.quant).reshape(1),
            gain=torch.as_tensor(gain, device="cuda"),
            offset=torch.as_tensor(off, device="cuda"))
    return cases


def run_cim_checks() -> tuple[dict, dict]:
    import torch
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels.cim import cim_mvm, cim_mvm_plain
    qcfg = QuantConfig(enabled=True)
    cases = cim_cases()
    summary = {"max_abs_err": 0.0, "max_abs_err_no_flip": 0.0,
               "adc_code_flips": 0, "outputs": 0}
    for name, c in cases.items():
        m, k = c["x"].shape
        n = c["w"].shape[1]
        lsb = float(c["fs"]) / 31
        for front in ("ideal", "die"):
            gain, off = ((None, None) if front == "ideal"
                         else (c["gain"], c["offset"]))
            got = cim_mvm(c["x"], c["w"], c["fs"], qcfg, gain, off)
            want = cim_mvm_plain(c["x"], c["w"], c["fs"], qcfg, gain, off)
            again = cim_mvm(c["x"], c["w"], c["fs"], qcfg, gain, off)
            torch.cuda.synchronize()
            err = (got - want).abs()
            flips = err > CIM_TOL["atol"]
            n_flips = int(flips.sum())
            check(n_flips <= 1e-4 * got.numel(),
                  f"CIM {name} {front}: {n_flips} outputs off by more "
                  f"than 1e-4")
            check(bool((err[flips] <= lsb * (1 + 1e-4)).all()),
                  f"CIM {name} {front}: an output off by more than one "
                  f"LSB ({lsb})")
            check(torch.allclose(got[~flips], want[~flips], **CIM_TOL),
                  f"CIM kernel != plain version: {name} {front}")
            identical = torch.equal(got, again)
            check(identical, f"two CIM launches differ: {name} {front}")
            rest = float(err[~flips].max()) if n_flips < err.numel() else 0.
            summary["max_abs_err"] = max(summary["max_abs_err"],
                                         float(err.max()))
            summary["max_abs_err_no_flip"] = max(
                summary["max_abs_err_no_flip"], rest)
            summary["adc_code_flips"] += n_flips
            summary["outputs"] += got.numel()
            emit({"kernel_check": "cim_mvm", "case": name, "front": front,
                  "M": m, "K": k, "N": n, "max_abs_err": float(err.max()),
                  "adc_code_flips": n_flips, "lsb": lsb,
                  "rtol": CIM_TOL["rtol"], "atol": CIM_TOL["atol"],
                  "bit_identical_relaunch": identical})
        ideal = cim_mvm(c["x"], c["w"], c["fs"], qcfg)
        zero = cim_mvm(c["x"], c["w"], c["fs"], qcfg,
                       torch.ones_like(c["gain"]),
                       torch.zeros_like(c["offset"]))
        torch.cuda.synchronize()
        check(torch.equal(ideal, zero),
              f"CIM {name}: zero-variation front end != ideal ADC")
    c = cases["ragged_8x192x70"]
    for what, args in (
            ("K % 64", (c["x"][:, :100].contiguous(), c["w"][:100])),
            ("a CPU operand", (c["x"], c["w"].cpu()))):
        try:
            cim_mvm(*args, c["fs"], qcfg)
        except ValueError:
            pass
        else:
            raise AssertionError(f"the CIM wrapper took {what}")
    emit({"cim_checks": "ok", **summary, "zero_variation_is_ideal": True})
    return summary, cases


# ----------------------------------------------------------------------
# main path
# ----------------------------------------------------------------------
def same_decisions(a: dict, b: dict, what: str,
                   atol: float = 1e-5) -> None:
    va = {v["rid"]: v for v in a["verdicts"]}
    vb = {v["rid"]: v for v in b["verdicts"]}
    check(set(va) == set(vb), f"{what}: different requests retired")
    for rid, x in va.items():
        y = vb[rid]
        check((x["verdict"], x["prediction"], x["n_samples"])
              == (y["verdict"], y["prediction"], y["n_samples"]),
              f"{what}: rid {rid} decided differently: {x} vs {y}")
        check(abs(x["confidence"] - y["confidence"]) <= atol
              and abs(x["mutual_information"]
                      - y["mutual_information"]) <= atol,
              f"{what}: rid {rid} confidence/MI differ: {x} vs {y}")


def run_main_path() -> dict:
    from repro_torch.kernels.decision import decision_stats
    from repro_torch.launch.serve import serve_sar
    from repro_torch.serving import TriagePolicy
    policy = TriagePolicy(**POLICY)
    kw = STREAM
    serve_sar(n_requests=32, policy=policy, device="cuda", **kw)  # warm-up

    decision_stats.launches = 0
    out = serve_sar(n_requests=192, policy=policy, device="cuda", **kw)
    launches = decision_stats.launches
    check(out["requests"] == 192 and out["decisions"] == 192,
          f"only {out['requests']} of 192 requests retired")
    check(out["host_syncs"] <= 192, f"host syncs {out['host_syncs']} > 192")
    check(launches > 0, "the main path launched no decision kernel")
    check(launches == out["rounds_launched"],
          f"kernel launches {launches} != rounds {out['rounds_launched']}")
    emit({"main_path": "serve_sar", "device": out["device"],
          "requests": out["requests"], "wall_s": out["wall_s"],
          "decisions_per_s_wall": out["decisions"] / out["wall_s"],
          "host_syncs": out["host_syncs"],
          "host_syncs_per_decision": out["host_syncs_per_decision"],
          "rounds_launched": out["rounds_launched"],
          "decision_kernel_launches": launches,
          "mean_samples_per_decision": out["mean_samples_per_decision"],
          "flag_fraction": out["flag_fraction"],
          "energy_total_J": out["energy_total_J"]})

    decision_stats.launches = 0
    plain = serve_sar(n_requests=192, policy=policy, device="cuda",
                      fused=False, **kw)
    check(decision_stats.launches == 0, "fused=False launched the kernel")
    same_decisions(out, plain, "fused vs fused=False on the card")

    esc = TriagePolicy(conf_threshold=0.55, mi_threshold=0.05, r_min=4,
                       r_max=20)
    esc_f = serve_sar(n_requests=192, policy=esc, device="cuda", **kw)
    esc_p = serve_sar(n_requests=192, policy=esc, device="cuda",
                      fused=False, **kw)
    same_decisions(esc_f, esc_p, "escalating policy, fused vs fused=False")
    depths = sorted({v["n_samples"] for v in esc_f["verdicts"]})
    check(len(depths) >= 3, f"escalating policy did not escalate: {depths}")

    cpu = serve_sar(n_requests=64, policy=policy, device="cpu", **kw)
    card = serve_sar(n_requests=64, policy=policy, device="cuda", **kw)
    same_decisions(card, cpu, "card vs CPU")
    emit({"cross_checks": "ok", "fused_vs_plain_requests": 192,
          "escalating_policy_depths": depths,
          "escalating_decisions_per_s_wall":
              esc_f["decisions"] / esc_f["wall_s"],
          "escalating_mean_samples_per_decision":
              esc_f["mean_samples_per_decision"],
          "escalating_host_syncs_per_decision":
              esc_f["host_syncs_per_decision"],
          "card_vs_cpu_requests": 64})
    return {"launches": launches}


def run_chip_path() -> dict:
    """The chip-instance main path on the card, and its cross-checks."""
    from repro_torch.kernels.cim import cim_mvm
    from repro_torch.kernels.decision import decision_stats
    from repro_torch.launch.serve import serve_sar
    from repro_torch.serving import TriagePolicy
    policy = TriagePolicy(**POLICY)
    die = gate_die()
    kw = dict(STREAM, policy=policy, chip_instance=die)
    serve_sar(n_requests=32, device="cuda", **kw)                # warm-up

    cim_mvm.launches = decision_stats.launches = 0
    out = serve_sar(n_requests=192, device="cuda", **kw)
    cim_launches, launches = cim_mvm.launches, decision_stats.launches
    check(out["chip_read_sigma"] > 0, "the gate die has no read noise")
    check(out["requests"] == 192 and out["decisions"] == 192,
          f"only {out['requests']} of 192 requests retired on the die")
    check(cim_launches == 3 * out["admissions"] > 0,
          f"CIM launches {cim_launches} != 3 x {out['admissions']} "
          f"admissions")
    check(launches == out["rounds_launched"] > 0,
          f"decision launches {launches} != rounds "
          f"{out['rounds_launched']}")
    emit({"main_path": "serve_sar(chip_instance=gate die)",
          "device": out["device"], "chip_id": out["chip_id"],
          "chip_device_seed": out["chip_device_seed"],
          "chip_read_sigma": out["chip_read_sigma"],
          "chip_temp_c": out["chip_temp_c"], "calibrated": out["calibrated"],
          "requests": out["requests"], "wall_s": out["wall_s"],
          "decisions_per_s_wall": out["decisions"] / out["wall_s"],
          "mean_samples_per_decision": out["mean_samples_per_decision"],
          "flag_fraction": out["flag_fraction"],
          "host_syncs": out["host_syncs"],
          "host_syncs_per_decision": out["host_syncs_per_decision"],
          "admissions": out["admissions"], "cim_kernel_launches":
          cim_launches, "rounds_launched": out["rounds_launched"],
          "decision_kernel_launches": launches})

    decision_stats.launches = 0
    plain = serve_sar(n_requests=192, device="cuda", fused=False, **kw)
    check(decision_stats.launches == 0, "fused=False launched the kernel")
    same_decisions(out, plain, "chip: fused vs fused=False on the card")
    esc = dict(kw, policy=TriagePolicy(**dict(POLICY, conf_threshold=0.55)))
    esc_f = serve_sar(n_requests=192, device="cuda", **esc)
    esc_p = serve_sar(n_requests=192, device="cuda", fused=False, **esc)
    same_decisions(esc_f, esc_p,
                   "chip, escalating policy: fused vs fused=False")
    depths = sorted({v["n_samples"] for v in esc_f["verdicts"]})
    check(len(depths) >= 3, f"escalating policy did not escalate: {depths}")
    uncal = serve_sar(n_requests=192, device="cuda",
                      **dict(kw, calibrated=False))
    check(uncal["requests"] == 192 and not uncal["calibrated"],
          "the uncalibrated die did not serve every request")
    card_vs_cpu = {"main": chip_card_vs_cpu(kw, die),
                   "escalating": chip_card_vs_cpu(esc, die)}
    kinds = card_vs_cpu["escalating"]["decision_kinds"]
    check(kinds >= 2, f"card vs CPU compared {kinds} kind of decision "
          f"under the escalating policy")
    emit({"chip_cross_checks": "ok", "fused_vs_plain_requests": 192,
          "escalating_policy_depths": depths,
          "escalating_decisions_per_s_wall":
              esc_f["decisions"] / esc_f["wall_s"],
          "escalating_mean_samples_per_decision":
              esc_f["mean_samples_per_decision"],
          "uncalibrated_requests": uncal["requests"],
          "uncalibrated_flag_fraction": uncal["flag_fraction"],
          "card_vs_cpu_requests": 64, "card_vs_cpu": card_vs_cpu})
    return {"launches": cim_launches}


def card_run_with_batches(n_requests: int, kw: dict) -> tuple[dict, list]:
    """``serve_sar`` on the card, keeping the image batch of every
    admission (the trunk's input, padding slots included)."""
    import numpy as np
    from repro_torch.launch.serve import serve_sar
    from repro_torch.serving.engine import SarServingEngine
    batches = []
    featurize = SarServingEngine.featurize

    def recording(engine, images):
        batches.append(np.array(images))
        return featurize(engine, images)

    SarServingEngine.featurize = recording
    try:
        out = serve_sar(n_requests=n_requests, device="cuda", **kw)
    finally:
        SarServingEngine.featurize = featurize
    return out, batches


def trunk_code_flips(batches: list, die) -> tuple[int, int]:
    """(outputs off by an ADC code, outputs) between the card's and the
    CPU's conv trunk on the gate die over ``batches``: each device runs
    the trunk on its own activations, as its engine does, from the
    params ``serve_sar`` makes.  Float order moves an output by ~1e-6, a
    flipped code by one LSB (more than CIM_TOL's atol); a flip also
    moves the outputs downstream of it, which count too."""
    import torch
    from repro_torch.models import sar_cnn
    from repro_torch.serving.engine import _to_device
    cfg = sar_cnn.SarCnnConfig()
    params = sar_cnn.init_sar_cnn(
        torch.Generator().manual_seed(3 + STREAM["seed"]), cfg)
    trunks = {"cpu": sar_cnn.program_trunk(params, cfg, die),
              "cuda": sar_cnn.program_trunk(_to_device(params, "cuda"),
                                            cfg, die)}
    flips = outputs = 0
    for images in batches:
        h = {d: torch.as_tensor(images, device=d) for d in trunks}
        for i in range(len(trunks["cpu"])):
            h = {d: sar_cnn._cim_conv(h[d], trunks[d][i], cfg) for d in h}
            gap = (h["cuda"].cpu() - h["cpu"]).abs()
            flips += int((gap > CIM_TOL["atol"]).sum())
            outputs += gap.numel()
    return flips, outputs


def chip_card_vs_cpu(kw: dict, die) -> dict:
    """64 requests on the gate die on the card and on the CPU: the same
    decisions; confidence and MI within TOL's atol unless the trunk
    flipped an ADC code between the two, then within CIM_CPU_ATOL."""
    from repro_torch.launch.serve import serve_sar
    card, batches = card_run_with_batches(64, kw)
    cpu = serve_sar(n_requests=64, device="cpu", **kw)
    flips, outputs = trunk_code_flips(batches, die)
    atol = CIM_CPU_ATOL if flips else TOL["atol"]
    same_decisions(card, cpu, f"chip: card vs CPU ({flips} trunk "
                   f"outputs off by an ADC code)", atol=atol)
    by_rid = {v["rid"]: v for v in cpu["verdicts"]}
    gap = max(max(abs(v[k] - by_rid[v["rid"]][k]) for k in
                  ("confidence", "mutual_information"))
              for v in card["verdicts"])
    return {"requests": card["requests"], "admissions": len(batches),
            "trunk_outputs": outputs, "trunk_code_flips": flips,
            "atol": atol, "max_confidence_mi_gap": gap,
            "flag_fraction": card["flag_fraction"],
            "decision_kinds": len({(v["verdict"], v["prediction"],
                                    v["n_samples"])
                                   for v in card["verdicts"]})}


# ----------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------
def call_ms(fn, iters: int, warmup: int = 50) -> float:
    """Per-call time of eager calls, host included: CUDA events around a
    Python loop of ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, replays: int = 5) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph,
    whose replay runs them back to back without the host; the least of
    ``replays`` timed replays, over ``iters``."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):              # warm-up outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(replays):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def decision_bound_ms(args: dict) -> tuple[float, str, int, int]:
    """Least time for one round: the bytes the function must move over
    HBM bandwidth, against the operations it must do over the float32
    rate.  A masked slot costs its mask byte and its zeroed outputs; an
    active slot also reads its rows of every per-slot input.  Returns
    (ms, bound_by, bytes, ops)."""
    b, n = args["y_mu"].shape
    r = args["sel"].shape[0]
    active = int(args["mask"].sum())
    per_slot = n * 4 * (2 + 16)                # y_mu, x_sigma, m rows
    shared = 0                                 # read once for all slots
    if args["sel"].ndim == 3:
        per_slot += r * 16 * 4
    else:
        shared += r * 16 * 4
    if args["cfg"].read_sigma > 0:
        per_slot += n * 4                      # x_sigsq
        if args["sample_idx"].ndim == 2:
            per_slot += r * 8
        else:
            shared += r * 8
        if args["rows"] is not None:
            per_slot += 8
    reads = b + active * per_slot + shared     # mask: one byte a slot
    writes = 2 * b * n * 4 + 2 * b * 4
    # per logit: 16-term mix (32), −sum_mean·x_sigma (2), /sum_std + y_mu
    # (2); softmax + entropy + the two sums (~8)
    ops = r * active * n * 44
    bytes_ms = (reads + writes) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms
            else "operations", reads + writes, ops)


def cim_bound_ms(c: dict) -> tuple[float, str, int, int]:
    """Least time for one CIM product: x, w, gain, offset and fs read
    once and out written once over HBM bandwidth, against 2·M·K·N
    multiply-adds plus the front end and ADC of every chunk (gain·psum +
    offset·lsb, divide, round, two clamps, code·lsb, accumulate: 8
    operations an output a chunk) over the float32 rate."""
    m, k = c["x"].shape
    n = c["w"].shape[1]
    nbytes = 4 * (m * k + k * n + 2 * n + 1 + m * n)
    ops = 2 * m * k * n + 8 * m * n * (k // 64)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms
            else "operations", nbytes, ops)


def cim_timing(cases: dict, launches: int, summary: dict) -> dict:
    """The CIM kernel's line: device and eager times at the three trunk
    shapes, with the die's front end, as the main path calls it."""
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels.cim import cim_mvm, cim_mvm_plain
    qcfg = QuantConfig(enabled=True)
    shapes = []
    for name in ("trunk0", "trunk1", "trunk2"):
        c = cases[name]
        args = (c["x"], c["w"], c["fs"], qcfg, c["gain"], c["offset"])

        def kernel():
            return cim_mvm(*args)

        def plain():
            return cim_mvm_plain(*args)

        bound, bound_by, nbytes, ops = cim_bound_ms(c)
        shapes.append({
            "case": name, "M": c["x"].shape[0], "K": c["x"].shape[1],
            "N": c["w"].shape[1], "ms": device_ms(kernel, 1000),
            "plain_ms": device_ms(plain, 1000),
            "call_ms": call_ms(kernel, 1000),
            "plain_call_ms": call_ms(plain, 1000), "bound_ms": bound,
            "bound_by": bound_by, "bound_bytes": nbytes, "bound_ops": ops})
    first = shapes[0]
    return {
        "name": "cim_mvm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cim_mvm.cu",
        "replaces": "src/repro/kernels/cim_mvm.py:72",
        "launches": launches,
        "max_abs_err": summary["max_abs_err"],
        "max_abs_err_no_flip": summary["max_abs_err_no_flip"],
        "adc_code_flips": summary["adc_code_flips"],
        "shape": "trunk0: M=7200 K=64 N=16 (the first conv of a 32-slot "
                 "admission), the gate die's front end; every trunk "
                 "shape under 'shapes'",
        "ms": first["ms"], "kernel_ms": first["ms"],
        "plain_ms": first["plain_ms"],
        "timing": "ms and plain_ms: device time per call, 1000 calls "
                  "replayed from one CUDA graph; call_ms: eager calls, "
                  "host included",
        "call_ms": first["call_ms"], "plain_call_ms": first["plain_call_ms"],
        "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call applies a per-chunk ADC "
                        "between the partial sums of a matrix product",
        "shapes": shapes,
    }


def run_timing(inputs: dict, launches: int, worst: float,
               cim_line: dict) -> None:
    from repro_torch.kernels.decision import (decision_stats,
                                              decision_stats_plain)
    times = {}
    for case in ("main_r4", "main_r20"):
        args = inputs[case]

        def kernel():
            return decision_stats(**args)

        def plain():
            return decision_stats_plain(**args)

        times[case] = dict(ms=device_ms(kernel, 1000),
                           plain_ms=device_ms(plain, 1000),
                           call_ms=call_ms(kernel, 1000),
                           plain_call_ms=call_ms(plain, 1000))
    bound, bound_by, nbytes, ops = decision_bound_ms(inputs["main_r4"])
    r4, r20 = times["main_r4"], times["main_r20"]
    emit({"kernels": [{
        "name": "decision_stats",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decision.cu",
        "replaces": "src/repro/kernels/decision_kernel.py:165",
        "launches": launches,
        "max_abs_err": worst,
        "shape": "B=32 N=2 R=4, half the slots masked",
        "ms": r4["ms"],
        "kernel_ms": r4["ms"],
        "plain_ms": r4["plain_ms"],
        "timing": "ms and plain_ms: device time per call, 1000 calls "
                  "replayed from one CUDA graph; call_ms: eager calls, "
                  "host included",
        "call_ms": r4["call_ms"],
        "plain_call_ms": r4["plain_call_ms"],
        "bound_ms": bound,
        "bound_by": bound_by,
        "bound_bytes": nbytes,
        "bound_ops": ops,
        "library_ms": None,
        "library_note": "no single PyTorch call computes the fused "
                        "mix -> softmax -> masked statistic sums",
        "ms_r20": r20["ms"],
        "plain_ms_r20": r20["plain_ms"],
        "call_ms_r20": r20["call_ms"],
        "plain_call_ms_r20": r20["plain_call_ms"],
        "bound_ms_r20": decision_bound_ms(inputs["main_r20"])[0],
    }, cim_line]})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    card = card_line()
    print(card, flush=True)            # verbatim, as nvidia-smi gives it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, _, power = card.partition(",")
    emit({"gpu": name.strip(), "power_limit": power.strip(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "device_count": torch.cuda.device_count(),
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    check(set(libs) == {"cim_mvm", "decision"},
          f"built {sorted(libs)}, expected cim_mvm and decision")
    ptxas = {n: [ln.strip() for ln in build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in libs}
    emit({"build_s": build_s, "libraries": sorted(libs), "ptxas": ptxas})

    worst, inputs = run_kernel_checks()
    cim_summary, cim_inputs = run_cim_checks()
    main_path = run_main_path()
    chip_path = run_chip_path()
    run_timing(inputs, main_path["launches"], worst,
               cim_timing(cim_inputs, chip_path["launches"], cim_summary))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
