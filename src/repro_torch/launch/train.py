"""The LM trainer (port of ``repro/launch/train.py``).

Trains any registered arch (its SMOKE config, or ``--full``) on one
card unless the caller asks for the CPU, with:

  * the stateless token pipeline (``data/tokens.batch_at``: a batch is
    a pure function of (seed, step), so a resumed run sees the batches
    an uninterrupted one would have; the port's own draws, not the
    reference's threefry ones: ``data/tokens``' docstring);
  * asynchronous checksummed checkpoints with atomic publish
    (``ckpt.AsyncCheckpointer``) and resume from the newest one;
  * the straggler monitor, its step durations in the metrics stream;
  * optional int8 gradient compression with error feedback
    (``--compress``; the error state starts from zero on resume, as the
    reference's does);
  * an optional simulated failure (``--fail-at N``: ``SystemExit`` after
    step N's checkpoint write has landed); rerunning the same command
    resumes.

Each step draws the Bayesian head's weights once, ε through the GRNG ε
kernel at [d_model, vocab_padded] on the card (``kernels/grng``), and
reads one thing back to the host: the step's metrics, in one pull.
Params start from a ``torch.Generator`` seeded 0 on the training device
(``launch/serve.params_init``), the reference's scales with the port's
draws.

With ``mesh_shape`` (``--mesh DATAxMODEL``) the step runs over a
(data, model) ``DeviceMesh`` through ``launch/steps.mesh_train_step``,
as the reference's trainer runs on ``make_debug_mesh()``: params and
AdamW state placed by ``sharding/specs``, the batch cut over 'data',
its rows' gradients pmean'd and the update applied piece by piece; the
head's ε is still drawn once a step, on the mesh's first device.
``devices`` (``--devices``) lists the mesh's devices row-major (a
device may repeat); without it every coordinate sits on ``device``,
one card.  Without ``mesh_shape`` the step is the one-device step,
which a (1, 1) mesh equals bit for bit.  Checkpoints hold the gathered
trees, so a run resumes on any mesh.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 200 --batch 8 --seq 64 --ckpt-dir /tmp/ck [--fail-at 60]
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --full --steps 30
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --full --steps 5 --mesh 2x2        # four coordinates on one card
  (``--device cpu`` trains on the CPU; without it the card is used and
  its absence raises.)
"""

from __future__ import annotations

import argparse
import contextlib
import json

import torch

from repro_torch import float32_math, resolve_device
from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import ARCHS, get_config
from repro_torch.data.tokens import (TokenPipelineConfig, batch_at,
                                     stub_frames, stub_image_embeds)
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import params_init
from repro_torch.launch.steps import (loss_and_grads, make_train_step,
                                      mesh_train_step)
from repro_torch.optim import (AdamWConfig, adamw_update, init_opt_state,
                               warmup_cosine)
from repro_torch.optim.compression import (compressed_gradients,
                                           init_error_state)
from repro_torch.runtime import StragglerConfig, StragglerMonitor
from repro_torch.sharding import gather
from repro_torch.utils.trees import tree_map


def build_batch(cfg, pipe_cfg: TokenPipelineConfig, step: int,
                device=None) -> dict:
    """Step ``step``'s batch: ``batch_at``'s tokens and labels and, for
    the audio / VLM families, the stub frames / image embeddings, made
    on the host and moved to ``device`` (on the card by asynchronous
    copies from pinned memory, so the loop does not wait on them)."""
    batch = batch_at(pipe_cfg, step)
    if cfg.family == "audio":
        batch["frames"] = stub_frames(pipe_cfg, cfg.n_frames, cfg.d_model,
                                      step, pipe_cfg.global_batch)
    if cfg.family == "vlm":
        batch["image_embeds"] = stub_image_embeds(
            pipe_cfg, cfg.n_image_tokens, cfg.d_model, step,
            pipe_cfg.global_batch)
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cpu":
        return batch
    return {k: v.pin_memory().to(dev, non_blocking=True)
            for k, v in batch.items()}


def pull_metrics(metrics: dict) -> dict:
    """The step's metrics as Python floats, the device's in one
    device-to-host read (the step's one host sync)."""
    on_device = [k for k, v in metrics.items()
                 if isinstance(v, torch.Tensor) and v.device.type != "cpu"]
    out = {k: float(v) for k, v in metrics.items() if k not in on_device}
    if on_device:
        vals = torch.stack([metrics[k].to(torch.float32)
                            for k in on_device]).tolist()
        out.update(zip(on_device, vals))
    return {k: out[k] for k in metrics}


def train(arch: str, *, smoke: bool = True, steps: int = 100,
          batch: int = 8, seq: int = 64, ckpt_dir: str | None = None,
          ckpt_every: int = 50, fail_at: int | None = None,
          compress: bool = False, lr: float = 3e-4, log_every: int = 10,
          metrics_path: str | None = None, device=None,
          mesh_shape: tuple | None = None, devices=None) -> dict:
    """Train ``arch`` for ``steps`` steps (from the newest checkpoint in
    ``ckpt_dir`` if there is one) on ``device`` (None = the card), or
    over a ``mesh_shape`` (data, model) mesh of ``devices`` (default:
    ``device`` at every coordinate) -> {params, opt (gathered, on the
    mesh's first device), history: one dict of metrics a step (with
    ``step_time``), final_loss, err: the compression error state or
    None}."""
    mesh = None
    if mesh_shape is None:
        dev = resolve_device(device)
    else:
        n = mesh_shape[0] * mesh_shape[1]
        mesh = make_mesh(tuple(mesh_shape), ("data", "model"),
                         [resolve_device(d) for d in devices]
                         if devices is not None
                         else [resolve_device(device)] * n)
        dev = mesh.first_device
        if compress:
            raise ValueError("--compress runs on one device; drop --mesh")
    cfg = get_config(arch, smoke=smoke)
    opt_cfg = AdamWConfig(lr=lr)
    pipe_cfg = TokenPipelineConfig(vocab=cfg.vocab, seq_len=seq,
                                   global_batch=batch)
    warmup = max(1, steps // 20)
    if mesh is None:
        base_step = make_train_step(cfg, opt_cfg, total_steps=steps,
                                    warmup_steps=warmup)
    else:
        base_step, _ = mesh_train_step(cfg, mesh, opt_cfg, seq, batch,
                                       total_steps=steps,
                                       warmup_steps=warmup)

    def compressed_step(params, opt_state, err, batch_, step):
        with float32_math():
            loss, metrics, grads = loss_and_grads(cfg, params, batch_, step)
            grads, err = compressed_gradients(grads, err)
            lr_scale = warmup_cosine(step, warmup_steps=warmup,
                                     total_steps=steps)
            params, opt_state, om = adamw_update(params, grads, opt_state,
                                                 opt_cfg, lr_scale)
        return params, opt_state, err, dict(metrics, loss=loss, **om)

    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        tree, start = restore(ckpt_dir)
        params, opt_state = (tree_map(lambda a: torch.as_tensor(
            a, device=dev), tree[k]) for k in ("params", "opt"))
        print(f"[train] resumed from step {start}")
    else:
        params = params_init(cfg, 0, dev)
        opt_state = init_opt_state(params)
    err_state = init_error_state(params) if compress else None

    ckptr = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    monitor = StragglerMonitor(StragglerConfig())
    history = []
    with (open(metrics_path, "a") if metrics_path
          else contextlib.nullcontext()) as metrics_file:
        for step in range(start, steps):
            monitor.start_step()
            data = build_batch(cfg, pipe_cfg, step, dev)
            if compress:
                params, opt_state, err_state, metrics = compressed_step(
                    params, opt_state, err_state, data, step)
            else:
                params, opt_state, metrics = base_step(params, opt_state,
                                                       data, step)
            metrics = pull_metrics(metrics)
            report = monitor.end_step(step)
            metrics["step_time"] = report["duration"]
            history.append({"step": step, **metrics})
            if metrics_file:
                metrics_file.write(json.dumps(history[-1]) + "\n")
                metrics_file.flush()
            if step % log_every == 0:
                print(f"[train] step {step} loss={metrics['loss']:.4f} "
                      f"ce={metrics['ce']:.4f} t={report['duration']:.2f}s")
            if ckptr and (step + 1) % ckpt_every == 0:
                ckptr.submit(step + 1, {"params": gather(params),
                                        "opt": gather(opt_state)})
            if fail_at is not None and step + 1 == fail_at:
                if ckptr:
                    ckptr.wait()
                raise SystemExit(
                    f"[train] simulated failure at step {step + 1}")
    params, opt_state = gather(params), gather(opt_state)
    if ckptr:
        ckptr.submit(steps, {"params": params, "opt": opt_state})
        ckptr.wait()
    return {"params": params, "opt": opt_state, "history": history,
            "final_loss": history[-1]["loss"] if history else None,
            "err": err_state}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="the published config, at full width")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--metrics", default=None,
                    help="append one JSON line of metrics a step here")
    ap.add_argument("--device", default=None,
                    help="'cpu' to train on the CPU (default: the card)")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="train over a (data, model) mesh, e.g. 2x2")
    ap.add_argument("--devices", default=None,
                    help="the mesh's devices, comma-separated, row-major "
                         "(default: --device at every coordinate)")
    args = ap.parse_args(argv)
    mesh_shape = (tuple(int(n) for n in args.mesh.lower().split("x"))
                  if args.mesh else None)
    if args.devices and not mesh_shape:
        ap.error("--devices needs --mesh")
    out = train(args.arch, smoke=args.smoke, steps=args.steps,
                batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, fail_at=args.fail_at,
                compress=args.compress, lr=args.lr,
                metrics_path=args.metrics, device=args.device,
                mesh_shape=mesh_shape,
                devices=args.devices.split(",") if args.devices else None)
    if out["final_loss"] is not None:
        print(f"[train] done, final loss {out['final_loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
