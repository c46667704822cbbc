#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; each prints a
JSON line):
  1. the card (name and power limit from nvidia-smi), torch and CUDA
     versions; TF32 is switched off for matmuls and convolutions;
  2. build every kernel from ``src/repro_torch/kernels/csrc`` with nvcc;
  3. every kernel against its plain PyTorch version on the card, at the
     main path's shapes and at ragged / read-noise / shared-selection
     shapes, plus a run-to-run bit-identity check (rtol 1e-5, atol 1e-5,
     as tests/test_decision_kernel.py);
  4. the main path: ``serve_sar`` on the card, 192 fog-mixed requests in
     32 slots under TriagePolicy(0.7, 0.05, r_min=4, r_max=20), random
     full-width params from a seed; the kernel launch counts are zeroed
     just before and read just after.  The same stream through
     ``fused=False`` (no kernel) must give the same decisions, and so
     must an escalating policy (0.55, 0.05) and a CPU run of 64 requests;
  5. kernel timing at the main path's shape: device time from CUDA
     graph replays and per-call time of eager calls (CUDA events), beside
     the plain version's and the card's byte/flop bound;
  6. last line: {"ok": true, "device": {...}}.
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
STAT_KEYS = ("sum_p", "sum_psq", "sum_ent", "sum_entsq")


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


# ----------------------------------------------------------------------
# main path
# ----------------------------------------------------------------------
def same_decisions(a: dict, b: dict, what: str) -> None:
    va = {v["rid"]: v for v in a["verdicts"]}
    vb = {v["rid"]: v for v in b["verdicts"]}
    check(set(va) == set(vb), f"{what}: different requests retired")
    for rid, x in va.items():
        y = vb[rid]
        check((x["verdict"], x["prediction"], x["n_samples"])
              == (y["verdict"], y["prediction"], y["n_samples"]),
              f"{what}: rid {rid} decided differently: {x} vs {y}")
        check(abs(x["confidence"] - y["confidence"]) <= 1e-5
              and abs(x["mutual_information"]
                      - y["mutual_information"]) <= 1e-5,
              f"{what}: rid {rid} confidence/MI differ: {x} vs {y}")


def run_main_path() -> dict:
    from repro_torch.kernels.decision import decision_stats
    from repro_torch.launch.serve import serve_sar
    from repro_torch.serving import TriagePolicy
    policy = TriagePolicy(conf_threshold=0.7, mi_threshold=0.05, r_min=4,
                          r_max=20)
    kw = dict(n_slots=32, corrupt_frac=0.25, corruption="fog", seed=0)
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


def run_timing(inputs: dict, launches: int, worst: float) -> None:
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
    }]})


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
    ptxas = {n: [ln.strip() for ln in build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in libs}
    emit({"build_s": build_s, "libraries": sorted(libs), "ptxas": ptxas})

    worst, inputs = run_kernel_checks()
    main_path = run_main_path()
    run_timing(inputs, main_path["launches"], worst)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
