"""Serving CLI: a thin layer over the port's engines (port of ``serve``,
``serve_sar`` and their CLI from ``repro/launch/serve.py``).

``--arch`` names a dense LM (qwen3-0.6b, qwen1.5-110b, yi-9b,
qwen3-1.7b), an MoE LM (mixtral-8x7b, qwen3-moe-235b-a22b), an SSM or
hybrid LM (mamba2-130m, zamba2-2.7b: prompts a multiple of the SSD
chunk, 16 at SMOKE and 256 at full width), the audio encoder-decoder
(whisper-medium: stub frames from ``data/tokens.stub_frames``; its
admissions wait for the pool to drain) or the VLM
(llama-3.2-vision-11b: stub patch embeddings from
``stub_image_embeds``), or ``sar_cnn``.  An LM
serves continuous-batching token decode through ``LMServingEngine``
(``serve``): prompts from the synthetic token pipeline, each token
decision triaged, flagged requests retired to verification; the CLI
serves the SMOKE config, as the reference's does (its ``--smoke`` is
always on), and full width is ``serve(arch, smoke=False)`` from Python.
Random params from a seed, drawn on the serving device
(``params_init``).

For ``sar_cnn`` the stream is synthetic SARD patches with a corrupted
fraction mixed in, classified by the Bayesian-head CNN with per-slot
escalation.  Both run on the card unless ``--device cpu`` is given,
and print one summary line (and one for the lifetime loop when the die
ages; a drift advisory is logged as it is raised).  ``--chip-instance
N`` serves on a die sampled with seed N: the conv trunk on its
nonideal CIM arrays, the Bayesian head on its degraded GRNG,
recalibrated per chip unless ``--uncalibrated``.

Telemetry is on by default (``--no-telemetry`` turns it off): the
summary then carries the telemetry snapshot, the drift status against
the deployment's belief and the alert bus's advisories.  With
``--age-rate`` (field seconds per decision) the die ages over the
stream, cut into ``--age-epochs`` segments; ``--auto-recalibrate``
heals on drift advisories between them (``serve_sar_lifetime``).

Time to verdict is tracked on every run (``obs/slo``; with ``--slo`` or
``--arrival`` a line gives its p50/p95/p99).  ``--slo TARGET:PCT[:BURN]``
(repeatable) declares objectives whose burn goes to the alert bus;
``--arrival SPEC`` drives the stream open-loop on a seeded schedule
(``serving/load``: ``poisson:RATE``, ``burst:RATE[:FACTOR]``,
``ramp:LO:HI``) instead of queueing it all at t = 0; ``--trace PATH``
writes a Chrome trace of the request spans; ``--metrics-out PREFIX``
writes ``PREFIX.prom`` and ``PREFIX.json`` (``obs/registry``);
``--profile DIR`` runs under ``torch.profiler``
(``obs/prof.trace_capture``) and adds the kernels' cost records to the
metrics.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --slots 4 --prompt-len 16 --gen 8 --requests 16 [--fixed]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \\
      --slots 2 --prompt-len 8 --gen 2 --requests 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --slots 2 --prompt-len 16 --gen 4 --requests 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \\
      --slots 2 --gen 4 --requests 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch sar_cnn \\
      --requests 192 --corrupt-frac 0.25 --corruption fog [--fixed] \\
      [--chip-instance 11 --chip-severity 2.0 --uncalibrated]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch sar_cnn \\
      --chip-instance 11 --chip-severity 2.5 --age-rate 27000 \\
      --age-epochs 4 --auto-recalibrate
  PYTHONPATH=src python -m repro_torch.launch.serve --arch sar_cnn \\
      --requests 192 --corrupt-frac 0.25 --slo 0.25:p99 \\
      --arrival poisson:1000 --trace out/trace.json \\
      --metrics-out out/serve --profile out/prof

``--pools P`` serves ``sar_cnn`` through a fleet of P pools of
``--slots-per-pool`` slots behind the least-loaded router
(``serve_sar_fleet``, ``serving/fleet.py``): one gang dispatch and one
pull a tick, pool p on ``cuda:{p mod device_count}`` (with ``--device``
every pool on that device).  On one card every pool shares it.  The
reference's ``--mesh N`` re-executes JAX with N fake host devices; the
port needs none and has no such flag.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch sar_cnn \\
      --pools 4 --slots-per-pool 32 --requests 256 --corrupt-frac 0.25
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.energy import LayerShape
from repro_torch.hw import compile_network
from repro_torch.obs.log import get_logger
from repro_torch.obs.telemetry import TelemetryConfig
from repro_torch.serving import (LMServingEngine, Request, SarServingEngine,
                                 ServingMetrics, TriagePolicy)

log = get_logger("serve")


def collect_alerts(out: dict, source: str):
    """The alert bus over a finished serve summary: its drift status,
    lifetime heal events, SLO burn breaches and (for a fleet's snapshot)
    backpressure become one typed advisory stream (logged as emitted;
    ``out["alerts"]`` when any)."""
    from repro_torch.obs.alerts import AlertBus
    bus = AlertBus()
    bus.observe_drift(out.get("drift"), source=source)
    for ev in (out.get("lifetime") or {}).get("events", []):
        bus.observe_heal(ev, source=source)
    bus.observe_slo(out.get("slo"), source=source)
    bus.observe_backpressure(out.get("slo"), source=source)
    if bus.advisories:
        out["alerts"] = bus.to_json()
    return bus


def lm_layer_shapes(cfg) -> list:
    """Analytic energy layers, as the reference's: a d_model-square
    trunk approximation (4 a layer of ``n_layers``) and the Bayesian
    vocabulary head (the R-sampled part).  An encoder's layers and the
    cross-attention layers are not counted: the reference's count
    leaves them out too."""
    shapes = [LayerShape(cfg.d_model, cfg.d_model)] * (4 * cfg.n_layers)
    shapes.append(LayerShape(cfg.d_model, cfg.vocab_padded, bayesian=True))
    return shapes


def params_init(cfg, seed: int = 0, device=None) -> dict:
    """Random LM params for ``cfg`` drawn on ``device`` (None = the
    card) from a ``torch.Generator`` seeded with ``seed``: the port's
    stand-in for the reference's ``jax_params_init`` (its scales, not
    its draws)."""
    from repro_torch.models.registry import get_api
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return get_api(cfg).init(gen, cfg)


def lm_extras(cfg, batch: int, prompt_len: int = 16, seed: int = 0,
              device=None) -> dict:
    """The memory inputs a family's prefill takes, as the reference's
    ``serve`` builds them: the audio family's stub frames [batch,
    n_frames, d_model] and the VLM's stub patch embeddings [batch,
    n_image_tokens, d_model] (``data/tokens``, step 0 of the prompts'
    pipeline); {} for the others."""
    from repro_torch.data.tokens import (TokenPipelineConfig, stub_frames,
                                         stub_image_embeds)
    pipe = TokenPipelineConfig(vocab=cfg.vocab, seq_len=prompt_len,
                               global_batch=batch, seed=seed)
    if cfg.family == "audio":
        return {"frames": stub_frames(pipe, cfg.n_frames, cfg.d_model, 0,
                                      batch, device)}
    if cfg.family == "vlm":
        return {"image_embeds": stub_image_embeds(
            pipe, cfg.n_image_tokens, cfg.d_model, 0, batch, device)}
    return {}


def make_lm_engine(cfg, *, batch: int = 4, prompt_len: int = 16,
                   gen_len: int = 8, cache_margin: int = 4,
                   adaptive: bool = True, policy: TriagePolicy | None = None,
                   params=None, seed: int = 0, fused: bool = True,
                   telemetry: bool | TelemetryConfig = True, tracer=None,
                   profiler=True, device=None) -> LMServingEngine:
    """The engine ``serve`` drives: ``batch`` slots, a linear cache of
    prompt_len + gen_len·(1 + cache_margin) (at most a sliding window),
    params from ``params_init(cfg, seed)`` unless given, the memory
    inputs of ``lm_extras(cfg, batch, prompt_len, seed)``, tilemap-true
    energy accounting of ``lm_layer_shapes``, on ``device`` (None = the
    card).  An SSM or hybrid config's ``prompt_len`` must be a multiple
    of its ``ssm_chunk`` (its SSD prefill takes whole chunks; 256 at
    full width): ValueError otherwise."""
    if cfg.family in ("ssm", "hybrid") and prompt_len % cfg.ssm_chunk:
        raise ValueError(
            f"{cfg.name}: prompt_len={prompt_len} is not a multiple of "
            f"ssm_chunk={cfg.ssm_chunk} (the SSD prefill takes whole "
            f"chunks)")
    device = resolve_device(device)
    if params is None:
        params = params_init(cfg, seed, device)
    extras = lm_extras(cfg, batch, prompt_len, seed, device)
    cache_len = prompt_len + gen_len * (1 + cache_margin)
    if cfg.swa_window is not None:
        cache_len = min(cache_len, cfg.swa_window)
    layers = lm_layer_shapes(cfg)
    metrics = ServingMetrics(layers=layers,
                             tile_program=compile_network(layers))
    return LMServingEngine(params, cfg, n_slots=batch, prompt_len=prompt_len,
                           cache_len=cache_len,
                           policy=policy or TriagePolicy(),
                           adaptive_mode=adaptive, metrics=metrics,
                           extras=extras, fused=fused, telemetry=telemetry,
                           tracer=tracer, profiler=profiler, device=device)


def make_lm_stream(cfg, n_requests: int, *, batch: int = 4,
                   prompt_len: int = 16, gen_len: int = 8,
                   seed: int = 0) -> list:
    """Requests whose prompts are the token pipeline's batches 0, 1, ...
    (``data/tokens``, ``batch`` prompts of ``prompt_len`` a batch), each
    asking for ``gen_len`` tokens."""
    from repro_torch.data.tokens import TokenPipelineConfig, batch_at
    pipe = TokenPipelineConfig(vocab=cfg.vocab, seq_len=prompt_len,
                               global_batch=batch, seed=seed)
    reqs, rid = [], 0
    for step in range(-(-n_requests // batch)):
        prompts = batch_at(pipe, step)["tokens"].numpy()
        for i in range(min(batch, n_requests - rid)):
            reqs.append(Request(rid=rid, payload=prompts[i],
                                arrival_s=time.time(),
                                max_new_tokens=gen_len))
            rid += 1
    return reqs


def serve(arch: str, *, smoke: bool = True, batch: int = 4,
          prompt_len: int = 16, gen_len: int = 8,
          n_requests: int | None = None, adaptive: bool = True,
          policy: TriagePolicy | None = None, seed: int = 0,
          cache_margin: int = 4, fused: bool = True,
          telemetry: bool | TelemetryConfig = True, tracer=None,
          profiler=True, cost_records: bool = False, params=None,
          cfg=None, device=None) -> dict:
    """LM serving through ``LMServingEngine``; ``batch`` is the slot
    count, ``n_requests`` defaults to 2·batch.  ``smoke`` selects the
    arch's SMOKE config, ``cfg`` overrides the arch's; ``params``
    (port params for that config) skip ``params_init``.  ``fused``: the
    decision kernel (False: ``mix_samples`` + ``update_stats``).
    Returns the metrics summary plus wall time, tokens/s, host syncs,
    ticks, admissions and per-request verdicts; ``cost_records`` adds
    the decision kernel's cost records and, on the card, the caching
    allocator's peak since the process started or its last reset."""
    cfg = cfg or get_config(arch, smoke=smoke)
    n_requests = n_requests or 2 * batch
    engine = make_lm_engine(cfg, batch=batch, prompt_len=prompt_len,
                            gen_len=gen_len, cache_margin=cache_margin,
                            adaptive=adaptive, policy=policy, params=params,
                            seed=seed, fused=fused, telemetry=telemetry,
                            tracer=tracer, profiler=profiler, device=device)
    reqs = make_lm_stream(cfg, n_requests, batch=batch,
                          prompt_len=prompt_len, gen_len=gen_len, seed=seed)
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    out = engine.run()
    out["wall_s"] = time.perf_counter() - t0
    out["tokens_per_s"] = out["decisions"] / out["wall_s"]
    out["arch"] = cfg.name
    out["device"] = str(engine.device)
    out["host_syncs"] = engine.host_syncs
    out["ticks"] = engine.ticks
    out["admissions"] = engine.admissions
    if cost_records:
        out["compiled_costs"] = engine.compiled_cost_records()
        if engine.device.type == "cuda":
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated(
                engine.device)
    out["flagged_fraction"] = out.get("flag_fraction", float("nan"))
    out["verdicts"] = [
        {"rid": r.rid, "verdict": r.verdict, "prediction": r.prediction,
         "confidence": r.confidence,
         "mutual_information": r.mutual_information,
         "n_samples": r.n_samples, "n_tokens": r.n_decisions}
        for r in engine.metrics.records]
    return out


def sar_layer_shapes(cfg) -> list:
    """Energy-model layers: the conv trunk as im2col matmuls + the
    Bayesian head."""
    shapes, c_in = [], 1
    for c_out in cfg.channels:
        shapes.append(LayerShape(cfg.kernel**2 * c_in, c_out))
        c_in = c_out
    shapes.append(LayerShape(cfg.channels[-1], cfg.n_classes, bayesian=True))
    return shapes


def make_sar_stream(n_requests: int, *, corrupt_frac: float = 0.0,
                    corruption: str = "fog", severity: float = 1.0,
                    image_size: int = 32, seed: int = 7, batch: int = 32,
                    step0: int = 1000) -> list:
    """Request stream over synthetic SARD with a corrupted head of every
    batch; ``meta={'corrupted': bool, 'label': int}``.  ``step0`` keeps
    serving off the training stream."""
    from repro_torch.data.sard import SardConfig, batch_at, corrupted_batch
    dcfg = SardConfig(image_size=image_size, seed=seed)
    reqs, rid = [], 0
    n_dirty = int(round(batch * corrupt_frac))
    for b in range((n_requests + batch - 1) // batch):
        clean = batch_at(dcfg, step0 + b, batch)
        dirty = (corrupted_batch(dcfg, step0 + b, batch, corruption,
                                 severity) if n_dirty else clean)
        for i in range(min(batch, n_requests - rid)):
            corrupted = i < n_dirty
            img = (dirty if corrupted else clean)["images"][i]
            reqs.append(Request(
                rid=rid, payload=img.numpy(), arrival_s=time.time(),
                meta={"corrupted": corrupted,
                      "label": int(clean["labels"][i])}))
            rid += 1
    return reqs


def make_sar_engine(*, n_slots: int = 32, adaptive: bool = True,
                    policy: TriagePolicy | None = None, params=None,
                    cfg=None, seed: int = 0, chip_instance=None,
                    calibrated: bool = True, fused: bool = True,
                    telemetry: bool | TelemetryConfig = True, head=None,
                    hcfg=None, tracer=None, profiler=True, slo=True,
                    device=None, slot_devices=None) -> SarServingEngine:
    """The engine ``serve_sar`` drives: untrained params from
    ``init_sar_cnn`` seeded ``3 + seed`` unless ``params`` is given,
    tilemap-true energy accounting (placed blocks of the compiled layer
    stack), on ``device`` (None = the card).

    ``chip_instance``: a ``hw.ChipInstance`` (or an int seed: one die
    from the default ``VariationSpec``).  The engine then serves fully
    on that die: the conv trunk on its nonideal CIM arrays, the head
    deployed by ``prepare_instance_head`` on ``device``, calibration
    included (``calibrated`` selects the per-chip recalibration over the
    golden factory transform).  The summary gains the die's metadata.
    ``head``/``hcfg``: a head already deployed on that die (the lifetime
    controller's), used as given.  ``tracer``/``profiler``/``slo``: the
    engine's host instruments (``SarServingEngine``); ``slot_devices``:
    its slot shards (the reference's ``slot_axis``), None for none.
    """
    from repro_torch.models.sar_cnn import SarCnnConfig, init_sar_cnn
    cfg = cfg or SarCnnConfig()
    device = resolve_device(device)
    if params is None:
        params = init_sar_cnn(torch.Generator().manual_seed(3 + seed), cfg)
    policy = policy or TriagePolicy(conf_threshold=0.7, mi_threshold=0.05)
    layers = sar_layer_shapes(cfg)
    extra = {}
    if chip_instance is not None:
        from repro_torch.core.bayes_layer import sigma_of
        from repro_torch.core.sampling import BayesHeadConfig
        from repro_torch.hw import prepare_instance_head, sample_instances
        if not hasattr(chip_instance, "grng"):
            chip_instance = sample_instances(int(chip_instance), 1)[0]
        base_hcfg = BayesHeadConfig(
            num_samples=policy.r_max, mode="rank16", grng=cfg.grng,
            compute_dtype=torch.float32, hoist_basis=True)
        if head is None:
            dev_head = {k: v.to(device) for k, v in params["head"].items()}
            head, hcfg = prepare_instance_head(
                dev_head["mu"], sigma_of(dev_head), base_hcfg,
                chip_instance, calibrated=calibrated)
        extra = {"chip_id": chip_instance.chip_id,
                 "chip_device_seed": chip_instance.device_seed,
                 "chip_read_sigma": chip_instance.read_sigma,
                 "chip_temp_c": chip_instance.temp_c,
                 "calibrated": bool(calibrated)}
    metrics = ServingMetrics(layers=layers, extra=extra,
                             tile_program=compile_network(layers))
    return SarServingEngine(params, cfg, n_slots=n_slots, policy=policy,
                            adaptive_mode=adaptive, metrics=metrics,
                            head=head, hcfg=hcfg, chip=chip_instance,
                            fused=fused, telemetry=telemetry, tracer=tracer,
                            profiler=profiler, slo=slo, device=device,
                            slot_devices=slot_devices)


def _engine_summary(out: dict, engine: SarServingEngine) -> dict:
    """The engine's counters, per-request verdicts and times to verdict
    (``time_to_verdict_s``, in the same order), added to ``out``."""
    out["device"] = str(engine.device)
    out["host_syncs"] = engine.host_syncs
    out["host_syncs_per_decision"] = (engine.host_syncs
                                      / max(out["decisions"], 1))
    out["rounds_launched"] = engine.rounds_launched
    out["admissions"] = engine.admissions
    out["flagged_fraction"] = out.get("flag_fraction", float("nan"))
    out["verdicts"] = [
        {"rid": r.rid, "verdict": r.verdict, "prediction": r.prediction,
         "confidence": r.confidence,
         "mutual_information": r.mutual_information,
         "n_samples": r.n_samples} for r in engine.metrics.records]
    out["time_to_verdict_s"] = [r.verdict_latency_s
                                for r in engine.metrics.records]
    return out


def serve_sar(*, n_requests: int = 128, n_slots: int = 32,
              adaptive: bool = True, policy: TriagePolicy | None = None,
              corrupt_frac: float = 0.0, corruption: str = "fog",
              params=None, cfg=None, seed: int = 0, chip_instance=None,
              calibrated: bool = True, fused: bool = True,
              telemetry: bool | TelemetryConfig = True, tracer=None,
              profiler=True, slo=(), arrival=None,
              cost_records: bool = False, device=None,
              slot_devices=None) -> dict:
    """SAR image-stream serving on ``device`` (None = the card) through
    ``make_sar_engine`` (``chip_instance``/``calibrated``: serve on a
    sampled die, see there).  Returns the metrics summary plus host
    syncs, rounds launched, admissions and per-request verdicts; with
    ``telemetry`` (the default) also the snapshot (``"telemetry"``), the
    drift status against the deployment's calibration-time belief
    (``"drift"``: the measured die config when calibrated, the factory
    config otherwise) and the alert bus's advisories (``"alerts"``).

    The engine's stage profile (``profiler``), build counters and SLO
    snapshot (``"slo"``: time-to-verdict histograms and percentiles)
    are in the summary.  ``slo``: SLO specs (``"0.25:p99"``) the
    tracker evaluates, or False for no tracking (the reference always
    tracks); ``profiler=False`` turns the stage profile off;
    ``tracer``: an ``obs.trace.Tracer``; ``arrival``: an arrival spec
    (``"poisson:8"`` or an ``ArrivalSpec``): the stream is then driven
    open-loop (``serving/load.run_open_loop``) on the schedule seeded by
    ``seed`` instead of queued at once; ``cost_records``: add the
    kernels' cost records (``"compiled_costs"``) and, on the card, the
    caching allocator's peak since the process started or its last
    reset (``"max_memory_allocated"``); ``slot_devices``: shard the
    pool's slots over these devices (``SarServingEngine``; the summary's
    ``shards`` says how many the rounds ran over)."""
    from repro_torch.obs.slo import SloTracker
    slo_tracker = (SloTracker(slos=tuple(slo)) if slo
                   else slo is not False)
    engine = make_sar_engine(n_slots=n_slots, adaptive=adaptive,
                             policy=policy, params=params, cfg=cfg,
                             seed=seed, chip_instance=chip_instance,
                             calibrated=calibrated, fused=fused,
                             telemetry=telemetry, tracer=tracer,
                             profiler=profiler, slo=slo_tracker,
                             device=device, slot_devices=slot_devices)
    reqs = make_sar_stream(n_requests, corrupt_frac=corrupt_frac,
                           corruption=corruption,
                           image_size=engine.cfg.image_size)
    t0 = time.perf_counter()
    if arrival is not None:
        from repro_torch.serving.load import ArrivalSpec, run_open_loop
        spec = (ArrivalSpec.parse(arrival) if isinstance(arrival, str)
                else arrival)
        out = run_open_loop(engine, reqs, spec.offsets(len(reqs),
                                                       seed=seed))
        out["arrival"] = spec.to_dict()
    else:
        for r in reqs:
            engine.submit(r)
        out = engine.run()
    out["wall_s"] = time.perf_counter() - t0
    if slo:        # the caller's tracker: the engine does not attach it
        out["slo"] = slo_tracker.snapshot()
    _engine_summary(out, engine)
    if cost_records:
        out["compiled_costs"] = engine.compiled_cost_records()
        if engine.device.type == "cuda":
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated(
                engine.device)
    if engine.tcfg is not None and out.get("telemetry"):
        from repro_torch.obs.drift import drift_status, reference_for
        ref = reference_for(engine.cfg, engine.hcfg,
                            calibrated=(chip_instance is not None
                                        and calibrated),
                            probe_cells=engine.tcfg.probe_cells,
                            device=engine.device)
        out["drift"] = drift_status(out["telemetry"], ref).to_dict()
        if out["drift"]["advisory"]:
            log.warning(out["drift"]["advisory"])
    collect_alerts(out, "serve_sar")
    return out


def serve_sar_fleet(*, n_requests: int = 256, n_pools: int = 4,
                    slots_per_pool: int = 32, adaptive: bool = True,
                    policy: TriagePolicy | None = None,
                    corrupt_frac: float = 0.0, corruption: str = "fog",
                    params=None, cfg=None, seed: int = 0,
                    chip_instance=None, calibrated: bool = True,
                    fused: bool = True, gang: bool | None = None,
                    queue_cap: int | None = None,
                    telemetry: bool | TelemetryConfig = True,
                    tracer=None, profiler=True, slo=(), arrival=None,
                    devices=None) -> dict:
    """Fleet SAR serving (``serving/fleet.SarServingFleet``): ``n_pools``
    complete pools of ``slots_per_pool`` slots behind the least-loaded
    router, pool p on ``devices[p]`` (default ``cuda:{p mod
    device_count}``; ``["cpu"] * n_pools`` on purpose).  ``gang``: one
    gang dispatch and one pull a tick (the default with more than one
    pool), False for one pull a pool.  Verdicts are those of standalone
    pools fed the same admissions; the summary is the exact sum of the
    pools' reports plus the router's (``routed_per_pool``,
    ``backlog_peak``), and ``verdicts`` (sorted by rid) carry each
    request's pool.

    ``chip_instance``/``calibrated``: every pool serves the same die (an
    int seed: one die from the default ``VariationSpec``), its head
    deployed on the first pool's device.  ``tracer``: one stitched
    timeline (router pid 0, pool p pid p + 1, a flow per request).
    ``slo``/``arrival``: as in ``serve_sar``; the SLO tracker is the
    fleet's, with its router latency, queue depths and backpressure."""
    from repro_torch.models.sar_cnn import SarCnnConfig, init_sar_cnn
    from repro_torch.obs.slo import SloTracker
    from repro_torch.serving import SarServingFleet
    from repro_torch.serving.fleet import pool_devices
    cfg = cfg or SarCnnConfig()
    devices = pool_devices(n_pools, devices)
    if params is None:
        params = init_sar_cnn(torch.Generator().manual_seed(3 + seed), cfg)
    policy = policy or TriagePolicy(conf_threshold=0.7, mi_threshold=0.05)
    layers = sar_layer_shapes(cfg)
    head = hcfg = None
    if chip_instance is not None:
        from repro_torch.core.bayes_layer import sigma_of
        from repro_torch.core.sampling import BayesHeadConfig
        from repro_torch.hw import prepare_instance_head, sample_instances
        if not hasattr(chip_instance, "grng"):
            chip_instance = sample_instances(int(chip_instance), 1)[0]
        base_hcfg = BayesHeadConfig(
            num_samples=policy.r_max, mode="rank16", grng=cfg.grng,
            compute_dtype=torch.float32, hoist_basis=True)
        dev_head = {k: v.to(devices[0]) for k, v in params["head"].items()}
        head, hcfg = prepare_instance_head(
            dev_head["mu"], sigma_of(dev_head), base_hcfg, chip_instance,
            calibrated=calibrated)
    slo_tracker = SloTracker(slos=tuple(slo)) if slo else True
    fleet = SarServingFleet(
        params, cfg, n_pools=n_pools, slots_per_pool=slots_per_pool,
        policy=policy, adaptive_mode=adaptive, head=head, hcfg=hcfg,
        chip=chip_instance, fused=fused, telemetry=telemetry,
        layers=layers, tile_program=compile_network(layers),
        queue_cap=queue_cap, gang=gang, tracer=tracer, profiler=profiler,
        slo=slo_tracker, devices=devices)
    reqs = make_sar_stream(n_requests, corrupt_frac=corrupt_frac,
                           corruption=corruption, image_size=cfg.image_size)
    if arrival is not None:
        from repro_torch.serving.load import ArrivalSpec, run_open_loop
        spec = (ArrivalSpec.parse(arrival) if isinstance(arrival, str)
                else arrival)
        out = run_open_loop(fleet, reqs, spec.offsets(len(reqs), seed=seed))
        out["arrival"] = spec.to_dict()
    else:
        for r in reqs:
            fleet.submit(r)
        out = fleet.run()
    if chip_instance is not None:
        out["chip_id"] = chip_instance.chip_id
        out["chip_device_seed"] = chip_instance.device_seed
        out["calibrated"] = bool(calibrated)
    out["devices"] = [str(d) for d in devices]
    out["flagged_fraction"] = out.get("flag_fraction", float("nan"))
    out["verdicts"] = sorted(
        ({"rid": r.rid, "pool": fleet.routes.get(r.rid),
          "verdict": r.verdict, "confidence": r.confidence,
          "mutual_information": r.mutual_information,
          "n_samples": r.n_samples}
         for eng in fleet.engines for r in eng.metrics.records),
        key=lambda v: v["rid"])
    collect_alerts(out, "serve_sar_fleet")
    return out


def serve_sar_lifetime(*, lifetime, chip_instance, n_requests: int = 128,
                       n_slots: int = 32, adaptive: bool = True,
                       policy: TriagePolicy | None = None,
                       corrupt_frac: float = 0.0, corruption: str = "fog",
                       params=None, cfg=None, seed: int = 0,
                       calibrated: bool = True, fused: bool = True,
                       telemetry: bool | TelemetryConfig = True,
                       tracer=None, profiler=True, device=None) -> dict:
    """SAR serving over a die's LIFETIME, on ``device`` (None: the card).

    The stream is cut into ``lifetime.epochs`` segments; before each
    segment after the first the die moves to the age its decision count
    implies (``lifetime.age_rate`` field seconds a decision) and the
    engine serves the stale belief on the aged physics; after each, the
    cumulative telemetry's delta folds into the die's drift monitor and,
    with ``lifetime.auto_recalibrate``, an advisory heals the die:
    recalibration at its age and a hot swap
    (``hw/redeploy.SelfHealingController`` + ``swap_head``).

    With ``lifetime.active`` False this IS ``serve_sar``: one segment,
    no controller, the same verdicts and host syncs.  Returns the serve
    summary plus ``out["lifetime"]``: age, heal events, advisory count
    and the final drift status.  ``tracer``/``profiler``: the engine's
    (``serve_sar``); its SLO snapshot covers every segment.
    """
    if not lifetime.active:
        out = serve_sar(n_requests=n_requests, n_slots=n_slots,
                        adaptive=adaptive, policy=policy,
                        corrupt_frac=corrupt_frac, corruption=corruption,
                        params=params, cfg=cfg, seed=seed,
                        chip_instance=chip_instance, calibrated=calibrated,
                        fused=fused, telemetry=telemetry, tracer=tracer,
                        profiler=profiler, device=device)
        out["lifetime"] = {"active": False, "age_s": 0.0, "heals": 0,
                           "advisories": 0, "epochs": 1}
        return out
    if chip_instance is None:
        raise ValueError("lifetime serving ages a specific die — pass "
                         "chip_instance (a ChipInstance or an int seed)")
    if telemetry is False:
        raise ValueError("lifetime serving watches drift through the "
                         "device-resident telemetry probe — telemetry "
                         "must stay enabled")
    from repro_torch.core.bayes_layer import sigma_of
    from repro_torch.core.sampling import BayesHeadConfig
    from repro_torch.hw import sample_instances
    from repro_torch.hw.redeploy import SelfHealingController
    from repro_torch.models.sar_cnn import SarCnnConfig, init_sar_cnn
    device = resolve_device(device)
    if not hasattr(chip_instance, "grng"):
        chip_instance = sample_instances(int(chip_instance), 1)[0]
    cfg = cfg or SarCnnConfig()
    if params is None:
        params = init_sar_cnn(torch.Generator().manual_seed(3 + seed), cfg)
    policy = policy or TriagePolicy(conf_threshold=0.7, mi_threshold=0.05)
    base_hcfg = BayesHeadConfig(
        num_samples=policy.r_max, mode="rank16", grng=cfg.grng,
        compute_dtype=torch.float32, hoist_basis=True)
    tcfg = telemetry if isinstance(telemetry, TelemetryConfig) \
        else TelemetryConfig()
    dev_head = {k: v.to(device) for k, v in params["head"].items()}
    ctl = SelfHealingController(
        chip_instance, dev_head["mu"], sigma_of(dev_head), base_hcfg,
        calibrated=calibrated, spec=lifetime.spec, gate=lifetime.gate,
        probe_cells=tcfg.probe_cells)
    engine = make_sar_engine(n_slots=n_slots, adaptive=adaptive,
                             policy=policy, params=params, cfg=cfg,
                             seed=seed, chip_instance=chip_instance,
                             calibrated=calibrated, fused=fused,
                             telemetry=tcfg, head=ctl.head, hcfg=ctl.hcfg,
                             tracer=tracer, profiler=profiler,
                             device=device)
    reqs = make_sar_stream(n_requests, corrupt_frac=corrupt_frac,
                           corruption=corruption,
                           image_size=cfg.image_size)
    epochs = max(1, int(lifetime.epochs))
    seg = -(-len(reqs) // epochs)
    served, advisories = 0, 0
    t0 = time.perf_counter()
    for k in range(epochs):
        chunk = reqs[k * seg:(k + 1) * seg]
        if not chunk:
            break
        if k:
            # drift arrives mid-stream: the die moves to the age its
            # decision count implies, the belief stays
            engine.swap_head(*ctl.advance(lifetime.age_rate * served))
        for r in chunk:
            engine.submit(r)
        out = engine.run()
        served += len(chunk)
        status = ctl.observe_snapshot(out["telemetry"])
        if status.drifted:
            advisories += 1
            log.warning(status.advisory)
        if lifetime.auto_recalibrate and status.drifted:
            ev = ctl.heal(status)
            engine.swap_head(*ctl.view())
            log.info("healed", age_s=ev.age_s, calib_epoch=ev.calib_epoch,
                     z_mean=round(ev.z_mean, 2), z_std=round(ev.z_std, 2))
    out["wall_s"] = time.perf_counter() - t0
    _engine_summary(out, engine)
    out["lifetime"] = dict(ctl.report(), active=True, epochs=epochs,
                           advisories=advisories,
                           age_rate=lifetime.age_rate,
                           auto_recalibrate=lifetime.auto_recalibrate)
    collect_alerts(out, "serve_sar_lifetime")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS + ("sar_cnn",), required=True)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="LM archs: the SMOKE config (always on, as the "
                         "reference's flag is)")
    ap.add_argument("--slots", type=int, default=None,
                    help="decode slots (default: 4 for LM, 32 for "
                         "sar_cnn)")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--fixed", action="store_true",
                    help="fixed R=r_max per decision (paper baseline)")
    ap.add_argument("--no-fused", dest="fused", action="store_false",
                    default=True,
                    help="use the materializing mix_samples → "
                         "update_stats path instead of the decision "
                         "kernel (verdict-identical)")
    ap.add_argument("--conf-threshold", type=float, default=0.8)
    ap.add_argument("--mi-threshold", type=float, default=0.5)
    ap.add_argument("--r-min", type=int, default=4)
    ap.add_argument("--r-max", type=int, default=20)
    ap.add_argument("--pools", type=int, default=None,
                    help="sar_cnn only: serve through a fleet of this many "
                         "engine pools behind the least-loaded router "
                         "(serving/fleet.py; one gang dispatch and one "
                         "pull a tick; pool p on cuda:{p mod devices}). "
                         "The reference's --mesh N (fake JAX host "
                         "devices) has no counterpart here")
    ap.add_argument("--slots-per-pool", type=int, default=32,
                    help="slots per fleet pool (with --pools)")
    ap.add_argument("--corrupt-frac", type=float, default=0.0)
    ap.add_argument("--corruption", default="fog",
                    choices=("fog", "frost", "motion", "snow"))
    ap.add_argument("--chip-instance", type=int, default=None,
                    help="serve on a sampled FeFET chip instance drawn "
                         "with this seed")
    ap.add_argument("--chip-severity", type=float, default=1.0,
                    help="variation severity multiplier for the sampled "
                         "chip")
    ap.add_argument("--uncalibrated", action="store_true",
                    help="skip per-instance recalibration (golden "
                         "factory transform on the degraded chip)")
    ap.add_argument("--age-rate", type=float, default=0.0,
                    help="simulated field seconds of FeFET aging per "
                         "decision (hw/aging.py); 0 serves the un-aged "
                         "path")
    ap.add_argument("--age-epochs", type=int, default=4,
                    help="age/heal checkpoints the stream is cut into")
    ap.add_argument("--auto-recalibrate", action="store_true",
                    help="act on drift advisories: recalibrate the aged "
                         "die and swap the healed head in mid-stream "
                         "(hw/redeploy.py)")
    ap.add_argument("--no-telemetry", dest="telemetry",
                    action="store_false", default=True,
                    help="serve without the device-resident telemetry "
                         "(obs/telemetry) and its drift check")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace JSON of the run's "
                         "request spans to PATH (with --pools: one "
                         "stitched fleet timeline, router ticks, per-pool "
                         "dispatch tracks and a flow arrow per request)")
    ap.add_argument("--arrival", default=None, metavar="SPEC",
                    help="drive serving open-loop on a seeded arrival "
                         "schedule instead of queueing everything at "
                         "once: poisson:RATE, burst:RATE[:FACTOR] or "
                         "ramp:LO:HI (req/s)")
    ap.add_argument("--slo", action="append", default=None,
                    metavar="TARGET:PCT[:BURN]",
                    help="time-to-verdict SLO, e.g. 0.25:p99 (repeatable):"
                         " attainment and error-budget burn land in the "
                         "summary, breaches on the alert bus")
    ap.add_argument("--metrics-out", default=None, metavar="PREFIX",
                    help="write PREFIX.prom (Prometheus text) and "
                         "PREFIX.json with the run's metrics, telemetry, "
                         "stage profile and SLO snapshot")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="run under torch.profiler, its Chrome trace "
                         "written into DIR, and add the kernels' cost "
                         "records to the metrics")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.arch != "sar_cnn":
        return _main_lm(args)
    chip = None
    if args.chip_instance is not None:
        from repro_torch.hw import VariationSpec, sample_instances
        chip = sample_instances(args.chip_instance, 1,
                                VariationSpec().scaled(args.chip_severity))[0]
    policy = TriagePolicy(conf_threshold=args.conf_threshold,
                          mi_threshold=args.mi_threshold,
                          r_min=args.r_min, r_max=args.r_max)
    tracer = None
    if args.trace:
        from repro_torch.obs.trace import Tracer
        tracer = Tracer("repro_torch-serving")
    kw = dict(n_requests=args.requests or 128, n_slots=args.slots or 32,
              adaptive=not args.fixed, policy=policy,
              corrupt_frac=args.corrupt_frac, corruption=args.corruption,
              chip_instance=chip, calibrated=not args.uncalibrated,
              fused=args.fused, telemetry=args.telemetry, tracer=tracer,
              device=args.device)
    from repro_torch.obs.prof import trace_capture
    if args.pools:
        with trace_capture(args.profile) as captured:
            out = serve_sar_fleet(
                n_requests=args.requests or 128, n_pools=args.pools,
                slots_per_pool=args.slots_per_pool,
                adaptive=not args.fixed, policy=policy,
                corrupt_frac=args.corrupt_frac, corruption=args.corruption,
                chip_instance=chip, calibrated=not args.uncalibrated,
                fused=args.fused, telemetry=args.telemetry, tracer=tracer,
                slo=tuple(args.slo or ()), arrival=args.arrival,
                devices=(None if args.device is None
                         else [args.device] * args.pools))
        print(f"[sar fleet] {out['decisions']} decisions in "
              f"{out['wall_s']:.2f}s ({out['decisions_per_s']:.1f}/s) over "
              f"{out['n_pools']} pools on {','.join(out['devices'])} "
              f"({'gang' if out['gang'] else 'sequential'}); routed "
              f"{out['routed_per_pool']}; backlog peak "
              f"{out['backlog_peak']}; host syncs/decision "
              f"{out['host_syncs_per_decision']:.3f}; "
              f"{100 * out['flagged_fraction']:.1f}% flagged")
        out["profile_trace"] = captured.path
        _write_outputs(args, out, tracer)
        return out
    with trace_capture(args.profile) as captured:
        if args.age_rate > 0.0 or args.auto_recalibrate:
            from repro_torch.hw.redeploy import LifetimeConfig
            out = serve_sar_lifetime(lifetime=LifetimeConfig(
                age_rate=args.age_rate, epochs=args.age_epochs,
                auto_recalibrate=args.auto_recalibrate), **kw)
        else:
            out = serve_sar(slo=tuple(args.slo or ()), arrival=args.arrival,
                            cost_records=bool(args.profile), **kw)
    chip_note = ""
    if chip is not None:
        chip_note = (f" [chip seed={args.chip_instance} "
                     f"id={out['chip_id']} "
                     f"device_seed={out['chip_device_seed']} "
                     f"read_sigma={out['chip_read_sigma']:.4f} "
                     f"T={out['chip_temp_c']:.1f}C "
                     f"{'cal' if out['calibrated'] else 'UNCAL'}]")
    print(f"[sar] {out['decisions']} decisions in {out['wall_s']:.2f}s "
          f"({out['decisions_per_s']:.1f}/s) on {out['device']}; "
          f"mean samples/decision "
          f"{out['mean_samples_per_decision']:.1f}; "
          f"{100 * out['flagged_fraction']:.1f}% flagged; GRNG "
          f"{out['grng_energy_per_decision_aJ']:.0f} aJ/decision; "
          f"host syncs/decision {out['host_syncs_per_decision']:.3f}"
          + chip_note)
    lt = out.get("lifetime")
    if lt and lt.get("active"):
        print(f"[lifetime] age {lt['age_s']:.0f}s over {lt['epochs']} "
              f"epochs: {lt['advisories']} advisories, {lt['heals']} "
              f"heals, calib_epoch {lt['calib_epoch']}")
    snap = out.get("slo")
    if snap and (args.slo or args.arrival):
        print(f"[slo] time to verdict p50 {snap['p50_s']:.4f}s p95 "
              f"{snap['p95_s']:.4f}s p99 {snap['p99_s']:.4f}s; queue-wait "
              f"share {snap['queue_wait_share']:.3f}"
              + "".join(f"; {s['name']} attainment {s['attainment']:.4f} "
                        f"burn {s['burn_rate']:.2f}"
                        f"{' BREACH' if s['breach'] else ''}"
                        for s in snap.get("slos", [])))
    out["profile_trace"] = captured.path
    _write_outputs(args, out, tracer)
    return out


def _write_outputs(args, out: dict, tracer) -> None:
    """The run's Chrome trace (``--trace``) and metrics exports
    (``--metrics-out``)."""
    if tracer is not None:
        d = os.path.dirname(args.trace)
        if d:
            os.makedirs(d, exist_ok=True)
        tracer.export(args.trace)
        log.info("trace written", path=args.trace,
                 events=len(tracer.events))
    if args.metrics_out:
        from repro_torch.obs.registry import serving_registry
        reg = serving_registry(
            {k: v for k, v in out.items()
             if isinstance(v, (int, float)) and not isinstance(v, bool)},
            telemetry=out.get("telemetry"), drift=out.get("drift"),
            profile=out.get("stage_profile"),
            compile_counters=out.get("compile_counters"),
            compiled_costs=out.get("compiled_costs"),
            slo=out.get("slo"), alerts=out.get("alerts"), arch=args.arch)
        prom, js = reg.write(args.metrics_out)
        log.info("metrics written", prom=prom, json=js)


def _main_lm(args) -> dict:
    """The CLI's LM branch: ``serve`` at the arch's SMOKE config."""
    policy = TriagePolicy(conf_threshold=args.conf_threshold,
                          mi_threshold=args.mi_threshold,
                          r_min=args.r_min, r_max=args.r_max)
    tracer = None
    if args.trace:
        from repro_torch.obs.trace import Tracer
        tracer = Tracer("repro_torch-serving")
    from repro_torch.obs.prof import trace_capture
    with trace_capture(args.profile) as captured:
        out = serve(args.arch, smoke=args.smoke, batch=args.slots or 4,
                    prompt_len=args.prompt_len, gen_len=args.gen,
                    n_requests=args.requests, adaptive=not args.fixed,
                    policy=policy, fused=args.fused,
                    telemetry=args.telemetry, tracer=tracer,
                    cost_records=bool(args.profile), device=args.device)
    print(f"[{args.arch}] {out['requests']} requests / {out['decisions']} "
          f"tokens in {out['wall_s']:.2f}s ({out['tokens_per_s']:.1f} "
          f"tok/s) on {out['device']}; mean samples/token "
          f"{out['mean_samples_per_decision']:.1f}; "
          f"{100 * out['flagged_fraction']:.1f}% flagged for verification;"
          f" host syncs {out['host_syncs']}")
    out["profile_trace"] = captured.path
    _write_outputs(args, out, tracer)
    return out


if __name__ == "__main__":
    main()
