"""The (data, model) mesh of the port against the JAX reference, on the
CPU (the card's checks are chip_smoke.py's ``mesh`` phase).

Every mesh here is a list of CPU devices (``["cpu"] * k``): a mesh may
repeat a device, and placement there adds no bytes.

  * ``launch/mesh``: the grid, ``make_debug_mesh``'s rule and the
    collectives as list operations; ``sharding/specs``: ``place`` /
    ``gather`` / ``place_rows`` / ``Placed.row_part`` round trips, and
    ``param_specs`` / ``opt_state_specs`` / ``cache_specs`` /
    ``batch_specs`` / ``logits_spec`` leaf for leaf equal to the
    reference's rules on the reference's own abstract trees, for every
    family's SMOKE config and five meshes (one with a 'pod' axis);
  * one subprocess with 8 fake JAX host devices, started before the
    module's first test and read by the tests that need it, runs the
    reference's ``make_sharded_moe`` (EP and TP-F, capacity factors 8
    and 1), ``jit_train_step`` on (2, 2) (two steps of qwen3-0.6b SMOKE
    in float32 and in bf16, and microbatches 4 against 1 at batch 8:
    ``tests/test_spmd.py``'s cases) and the elastic meshes' shapes;
  * ``models/moe.make_sharded_moe`` against it within MOE_ATOL (the
    reference's own tolerance), its drops at capacity factor 1 included
    (counted and asserted non-zero), and at factor 8 against
    ``moe_apply``;
  * ``launch/steps.mesh_train_step`` against ``jit_train_step`` (loss
    F32_LOSS_REL / BF16_LOSS_REL, the bf16 gradient norm BF16_GRAD_REL
    as ROADMAP C32 states it, params F32_PARAM_ATOL after two steps) and against the port's own unsharded step (float32 loss
    F32_LOSS_REL) for every family; microbatches 4 against 1 within the
    reference's MICROBATCH_ATOL; explicit TP on and off;
    ``mesh_prefill_step`` / ``mesh_decode_step`` against the unsharded
    steps (F32_REL), mixtral's through its sharded MoE;
  * ``runtime/elastic`` (``tests/test_spmd.py:87-102``'s case and a
    train state that continues after a re-mesh); ``launch/train`` on a
    (1, 1) mesh bit for bit the one-device trainer, and the CLI's
    ``--mesh``; the bridge's placed trees.
"""

import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.launch import steps as jsteps
from repro.optim import init_opt_state as jinit_opt_state
from repro.sharding import specs as JS
from repro.utils.trees import tree_map_with_name as jmap_named
from repro_torch import bridge
from repro_torch.configs import ARCHS, get_config
from repro_torch.data.tokens import TokenPipelineConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch.serve import params_init
from repro_torch.models import moe as tmoe
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.runtime import (make_elastic_mesh, remesh_train_state,
                                 shrink_mesh)
from repro_torch.sharding import specs as S
from repro_torch.utils.trees import leaves, tree_map_with_name, \
    unflatten_dict

ROOT = Path(__file__).resolve().parents[1]
MOE_ATOL = 2e-5            # tests/test_spmd.py's sharded-MoE tolerance
F32_LOSS_REL = 1e-5
BF16_LOSS_REL = 1e-3       # ROADMAP C32
BF16_GRAD_REL = 0.05       # ROADMAP C32: bf16 gradient norms
F32_PARAM_ATOL = 1e-6
F32_REL = 1e-5             # serving samples: max error over max entry
MICROBATCH_ATOL = 5e-2     # tests/test_spmd.py:285-288
MOE_CASES = {              # name: (mesh, E, capacity factor)
    "ep_2x2_cf8": ((2, 2), 4, 8.0), "ep_2x2_cf1": ((2, 2), 4, 1.0),
    "ep_1x4_cf1": ((1, 4), 4, 1.0),
    "tpf_2x4_cf8": ((2, 4), 6, 8.0), "tpf_2x4_cf1": ((2, 4), 6, 1.0)}
MOE_DIMS = dict(b=8, s=16, d=32, f=64, k=2)
TRAIN_CASES = {            # tag: (arch, float32, microbatches, B)
    "f32": ("qwen3-0.6b", True, 1, 4),
    "bf16": ("qwen3-0.6b", False, 1, 8),    # also microbatches 1
    "mb4": ("qwen3-0.6b", False, 4, 8)}
TRAIN_STEPS = 2            # step 0 has lr 0 (warmup): step 1 moves params
ELASTIC = ((8, [6, 7]), (4, [3]), (4, [2, 3]), (6, [0]))  # (n, lost ids)

# The reference side, in one subprocess with 8 fake host devices.  It
# reads the MoE inputs from argv[1] and writes to argv[2].
_SPMD = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.data.tokens import TokenPipelineConfig, batch_at
from repro.launch.mesh import make_debug_mesh, make_mesh_compat, \
    mesh_context
from repro.launch.steps import jit_train_step
from repro.models.moe import make_sharded_moe, moe_apply
from repro.models.registry import get_api
from repro.optim import AdamWConfig, init_opt_state
from repro.runtime import make_elastic_mesh, shrink_mesh
from repro.utils.trees import flatten_dict

inp = np.load(sys.argv[1])
cases = json.loads(sys.argv[3])
out = {}
for name, (shape, e, cf) in cases["moe"].items():
    x, r, wi, wg, wo = (jnp.asarray(inp[f"{name}_{k}"])
                        for k in ("x", "router", "wi", "wg", "wo"))
    mesh = make_mesh_compat(tuple(shape), ("data", "model"))
    with mesh_context(mesh):
        moe = make_sharded_moe(mesh, top_k=cases["k"], capacity_factor=cf,
                               n_experts=e, dp_axes=("data",))
        y, aux = jax.jit(moe)(x, r, wi, wg, wo)
    out[f"moe_{name}_y"], out[f"moe_{name}_aux"] = np.asarray(y), np.asarray(aux)
    y0, aux0 = moe_apply(x, r, wi, wg, wo, top_k=cases["k"],
                         capacity_factor=cf)
    out[f"moe_{name}_y_unsharded"] = np.asarray(y0)

for tag, (arch, f32, mb, b) in cases["train"].items():
    cfg0 = get_config(arch, smoke=True)
    if f32:
        cfg0 = dataclasses.replace(cfg0, dtype=jnp.float32)
    pipe = TokenPipelineConfig(vocab=cfg0.vocab, seq_len=16, global_batch=b)
    params = get_api(cfg0).init(jax.random.PRNGKey(0), cfg0)
    opt = init_opt_state(params)
    if tag == "f32":
        for k, v in flatten_dict(jax.device_get(params)).items():
            out[f"init_{arch}/{k}"] = np.asarray(v)
    mesh = make_mesh_compat((2, 2), ("data", "model"))
    with mesh_context(mesh):
        jitted, _, _, cfg2 = jit_train_step(cfg0, mesh, AdamWConfig(), 16,
                                            b, microbatches=mb)
        for s in range(cases["steps"]):
            batch = {k: np.asarray(v) for k, v in batch_at(pipe, s).items()}
            for k, v in batch.items():
                out[f"batch_{tag}_{s}_{k}"] = v
            params, opt, m = jitted(params, opt, batch)
            for k, v in m.items():
                out[f"train_{tag}_{s}_{k}"] = np.float64(v)
    if f32:
        for k, v in flatten_dict(jax.device_get(params)).items():
            out[f"after_{tag}/{k}"] = np.asarray(v)

shapes = {}
for n, lost in cases["elastic"]:
    devs = jax.devices()[:n]
    m = make_elastic_mesh(devs)
    m2 = shrink_mesh(m, {devs[i].id for i in lost})
    shapes[f"{n}_{lost}"] = [list(m.devices.shape), list(m2.devices.shape)]
for n in (1, 2, 3, 4, 6, 8):
    shapes[f"debug_{n}"] = list(make_debug_mesh(n).devices.shape)
out["shapes"] = np.frombuffer(json.dumps(shapes).encode(), np.uint8)
np.savez(sys.argv[2], **out)
print("OK")
"""


def _moe_inputs(name: str, e: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    d, f = MOE_DIMS["d"], MOE_DIMS["f"]
    f32 = np.float32
    return {"x": rng.standard_normal((MOE_DIMS["b"], MOE_DIMS["s"], d)
                                     ).astype(f32),
            "router": (rng.standard_normal((d, e)) / np.sqrt(d)).astype(f32),
            "wi": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(f32),
            "wg": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(f32),
            "wo": (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(f32)}


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    """The reference's sharded runs, in ONE subprocess with 8 fake host
    devices, started first and read last (its compiles overlap the
    in-process tests)."""
    import json
    d = tmp_path_factory.mktemp("mesh")
    inputs = {name: _moe_inputs(name, e, i)
              for i, (name, (_, e, _)) in enumerate(MOE_CASES.items())}
    np.savez(d / "in.npz", **{f"{n}_{k}": v for n, c in inputs.items()
                              for k, v in c.items()})
    cases = {"moe": MOE_CASES, "k": MOE_DIMS["k"], "train": TRAIN_CASES,
             "steps": TRAIN_STEPS, "elastic": ELASTIC}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _SPMD, str(d / "in.npz"), str(d / "out.npz"),
         json.dumps(cases)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    result = {}

    def read():
        if not result:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            got = dict(np.load(d / "out.npz"))
            result["shapes"] = json.loads(got.pop("shapes").tobytes())
            result["out"] = got
            result["inputs"] = inputs
        return result

    yield read
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def _start_spmd(spmd):
    """Start the subprocess before the module's first test, and leave
    it most of the cores: the tests here are small and run in two
    threads until the module ends."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield spmd
    torch.set_num_threads(threads)


def _cpu_mesh(shape) -> tmesh.DeviceMesh:
    return tmesh.make_mesh(shape, ("data", "model"),
                           ["cpu"] * (shape[0] * shape[1]))


def _tree(out: dict, prefix: str) -> dict:
    """A tree the subprocess flattened under ``prefix`` as tensors."""
    flat = {k[len(prefix) + 1:]: v for k, v in out.items()
            if k.startswith(prefix + "/")}
    return bridge.lm_params_from_jax(unflatten_dict(flat))


def _f32(cfg):
    return dataclasses.replace(cfg, dtype=torch.float32)


# ----------------------------------------------------------------------
# launch/mesh and placement
# ----------------------------------------------------------------------
def test_mesh_grid_and_collectives():
    m = _cpu_mesh((2, 3))
    assert m.shape == {"data": 2, "model": 3} and m.size == 6
    assert m.coords()[:4] == [(0, 0), (0, 1), (0, 2), (1, 0)]
    assert m.first_device == torch.device("cpu")
    assert tmesh.axis_index(m, "model", (1, 2)) == 2
    assert tmesh.axis_index(m, "data", (1, 2)) == 1
    xs = [torch.arange(4.0).reshape(2, 2) + 10 * i for i in range(3)]
    np.testing.assert_array_equal(
        tmesh.all_gather(xs, m, "model", 1).numpy(),
        np.concatenate([x.numpy() for x in xs], 1))
    np.testing.assert_array_equal(tmesh.psum(xs, m, "model").numpy(),
                                  xs[0] + xs[1] + xs[2])
    np.testing.assert_allclose(tmesh.pmean(xs[:2], m, "data").numpy(),
                               (xs[0] + xs[1]).numpy() / 2)
    with pytest.raises(ValueError):
        tmesh.psum(xs, m, "data")
    with pytest.raises(ValueError):
        tmesh.make_mesh((2, 2), devices=["cpu"] * 3)


def test_place_adds_no_bytes_and_gathers_bit_for_bit():
    cfg = get_config("qwen3-0.6b", smoke=True)
    params = params_init(cfg, 0, "cpu")
    mesh = _cpu_mesh((2, 2))
    placed = S.place(params, S.param_specs, mesh)
    assert S.validate_specs(params, S.param_specs(params, mesh), mesh) == []
    bases = {x.untyped_storage().data_ptr() for x in leaves(params)}
    n_sharded = 0
    for x, p in zip(leaves(params), leaves(placed)):
        assert isinstance(p, S.Placed) and len(p.pieces) == 4
        for piece in p.pieces.values():    # views: no byte of their own
            assert piece.untyped_storage().data_ptr() in bases
        n_sharded += len(p.distinct()) > 1
        assert torch.equal(p.gather(), x)
    assert n_sharded >= 8
    wq = placed["blocks"]["attn"]["wq"]
    assert wq.spec == S.P(None, "data", "model")
    assert len(wq.distinct()) == 4         # one slice a coordinate
    assert len(placed["final_norm"].distinct()) == 1   # replicated


def test_place_rows_and_row_part_round_trip():
    mesh = _cpu_mesh((2, 2))
    k = torch.arange(2 * 4 * 6 * 3, dtype=torch.float32).reshape(2, 4, 6, 3)
    spec = S.P(None, "data", "model", None)
    rows = [k[:, :2], k[:, 2:]]
    got = S.place_rows(rows, 1, spec, mesh)
    assert torch.equal(got.gather(), k)
    assert torch.equal(S.place_tensor(k, spec, mesh).pieces[(1, 1)],
                       got.pieces[(1, 1)])
    for r in range(2):
        assert torch.equal(got.row_part(1, r, 2), rows[r])
    rep = S.place_tensor(k, S.P(), mesh)             # replicated
    assert torch.equal(rep.row_part(1, 1, 2), rows[1])
    assert torch.equal(rep.row_part(1, 0, 1), k)
    with pytest.raises(ValueError):
        S.place_tensor(torch.zeros(3, 4), S.P("data"), mesh)


# ----------------------------------------------------------------------
# Specs: leaf for leaf the reference's, on its own abstract trees
# ----------------------------------------------------------------------
FAKE_MESHES = [dict(data=2, model=2), dict(data=4, model=2),
               dict(data=1, model=4), dict(data=2, model=4),
               dict(pod=2, data=2, model=2)]


def _fake(shape: dict):
    return types.SimpleNamespace(shape=shape, axis_names=tuple(shape))


def _named(tree, jax_side: bool) -> dict:
    out = {}
    if jax_side:
        jmap_named(lambda n, s: out.setdefault(n, tuple(s)), tree)
    else:
        tree_map_with_name(lambda n, s: out.setdefault(n, tuple(s)), tree)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_reference_for_every_family(arch):
    assert set(ARCHS) == set(JARCHS)
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    seq = 16
    jparams = jsteps.abstract_params(jcfg)
    jopt = jax.eval_shape(lambda p: jinit_opt_state(p, True), jparams)
    jcache = jsteps.abstract_cache(jcfg, seq, 4)
    params = params_init(cfg, 0, "cpu")
    opt = init_opt_state(params, master_weights=True)
    batch = ttrain.build_batch(cfg, TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=4), 0)
    cache, _ = tsteps.make_prefill_step(cfg, seq)(
        params, {k: v for k, v in batch.items() if k != "labels"})
    for shape in FAKE_MESHES:
        mesh = _fake(shape)
        for rule, jtree, tree in ((JS.param_specs, jparams, params),
                                  (JS.opt_state_specs, jopt, opt),
                                  (JS.cache_specs, jcache, cache),
                                  (JS.batch_specs, batch, batch)):
            port = getattr(S, rule.__name__)
            want = _named(rule(jtree, mesh), True)
            got = _named(port(tree, mesh), False)
            assert got == want, (arch, shape, rule.__name__)
        for b in (1, 2, 4, 6):
            assert tuple(S.logits_spec(mesh, b)) == tuple(
                JS.logits_spec(mesh, b))
        bad = S.validate_specs(params, S.param_specs(params, mesh), mesh)
        assert bad == JS.validate_specs(jparams,
                                        JS.param_specs(jparams, mesh), mesh)


# ----------------------------------------------------------------------
# The sharded MoE
# ----------------------------------------------------------------------
def test_dispatch_local_cut_and_sentinel():
    """§Perf I1b's cut: with one local expert of four, q = 2·capacity
    < T·k, and local pairs past q drop as an overflow does; foreign
    pairs never land in the buffer."""
    t, k, e_loc, cap = 12, 2, 1, 4
    g = torch.Generator().manual_seed(3)
    experts = torch.randint(0, 4, (t, k), generator=g)
    xf = torch.randn(t, 8, generator=g)
    w = torch.rand(t, k, generator=g)
    for e0 in range(4):
        xe, slot, keep, tok, ws = tmoe._dispatch_local(xf, experts, w, e0,
                                                       e_loc, cap)
        assert keep.shape[0] == min(t * k, 2 * e_loc * cap)
        local = (experts.reshape(-1) == e0).nonzero()[:, 0]
        assert int(keep.sum()) == min(len(local), cap)
        np.testing.assert_array_equal(tok[keep].numpy(),
                                      (local[:cap] // k).numpy())
        assert torch.equal(xe[0, :int(keep.sum())], xf[local[:cap] // k])


# ----------------------------------------------------------------------
# The mesh train step
# ----------------------------------------------------------------------
def _train_cfg(tag):
    arch, f32, _, _ = TRAIN_CASES[tag]
    cfg = get_config(arch, smoke=True)
    return _f32(cfg) if f32 else cfg


def _run_mesh_steps(tag, out, init_prefix, mesh_shape=(2, 2)):
    arch, _, mb, b = TRAIN_CASES[tag]
    cfg = _train_cfg(tag)
    step, cfg2 = tsteps.mesh_train_step(cfg, _cpu_mesh(mesh_shape),
                                        AdamWConfig(), 16, b,
                                        microbatches=mb)
    assert cfg2.batch_axes == ("data",) and cfg2.model_axis_size == \
        mesh_shape[1]
    params = _tree(out, init_prefix)
    opt = init_opt_state(params)
    losses = []
    for s in range(TRAIN_STEPS):
        batch = {k: torch.as_tensor(out[f"batch_{tag}_{s}_{k}"])
                 for k in ("tokens", "labels")}
        params, opt, m = step(params, opt, batch, s)
        losses.append({k: float(v) for k, v in m.items()})
    return params, opt, losses


@pytest.mark.parametrize("shape,explicit_tp", [
    ((2, 2), False), ((2, 2), True), ((1, 4), True), ((4, 1), False)])
def test_mesh_train_step_matches_unsharded(shape, explicit_tp):
    cfg = dataclasses.replace(_f32(get_config("qwen3-0.6b", smoke=True)),
                              explicit_tp=explicit_tp)
    batch = ttrain.build_batch(cfg, TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=16, global_batch=4), 0)
    params = params_init(cfg, 0, "cpu")
    one = tsteps.make_train_step(cfg, AdamWConfig())
    mesh_step, _ = tsteps.mesh_train_step(cfg, _cpu_mesh(shape),
                                          AdamWConfig(), 16, 4)
    p1, o1 = params, init_opt_state(params)
    p2, o2 = params, init_opt_state(params)
    for s in range(TRAIN_STEPS):
        p1, o1, m1 = one(p1, o1, batch, s)
        p2, o2, m2 = mesh_step(p2, o2, batch, s)
        np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                                   rtol=F32_LOSS_REL)
    for a, b in zip(leaves(S.gather(p2)), leaves(p1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=F32_PARAM_ATOL)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "zamba2-2.7b",
                                  "whisper-medium", "llama-3.2-vision-11b"])
def test_mesh_train_step_every_family(arch):
    """Each family's step on (2, 2) with explicit TP against the port's
    unsharded step: the loss's ce and KL within F32_LOSS_REL; mixtral's
    layers take the sharded MoE (at capacity factor 8, so that no row
    drops a pair), whose aux is the rows' pmean (the reference's), so
    only its aux differs."""
    cfg = dataclasses.replace(_f32(get_config(arch, smoke=True)),
                              explicit_tp=True, capacity_factor=8.0)
    seq = cfg.ssm_chunk if cfg.family in ("ssm", "hybrid") else 16
    batch = ttrain.build_batch(cfg, TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=4), 0)
    params = params_init(cfg, 0, "cpu")
    _, _, m1 = tsteps.make_train_step(cfg, AdamWConfig())(
        params, init_opt_state(params), batch, 1)
    step, _ = tsteps.mesh_train_step(cfg, _cpu_mesh((2, 2)), AdamWConfig(),
                                     seq, 4)
    _, _, m2 = step(params, init_opt_state(params), batch, 1)
    for k in ("ce", "kl"):
        np.testing.assert_allclose(float(m2[k]), float(m1[k]),
                                   rtol=F32_LOSS_REL, err_msg=k)
    assert np.isfinite(float(m2["grad_norm"]))


def test_train_step_eps_draw_once_a_step(monkeypatch):
    """The head's weights are drawn once a step on the mesh's first
    device (one ε kernel launch on the card), not once a row."""
    from repro_torch.core import bayes_layer
    calls = []
    real = bayes_layer.sample_weights_at
    monkeypatch.setattr(bayes_layer, "sample_weights_at",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = _f32(get_config("qwen3-0.6b", smoke=True))
    batch = ttrain.build_batch(cfg, TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=16, global_batch=4), 0)
    params = params_init(cfg, 0, "cpu")
    step, _ = tsteps.mesh_train_step(cfg, _cpu_mesh((2, 2)), AdamWConfig(),
                                     16, 4)
    step(params, init_opt_state(params), batch, 0)
    assert len(calls) == 1


# ----------------------------------------------------------------------
# Serving steps over the mesh
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b",
                                  "mamba2-130m", "zamba2-2.7b",
                                  "whisper-medium", "llama-3.2-vision-11b"])
def test_mesh_prefill_decode_match_unsharded(arch):
    """Prefill (a prompt shorter than the cache) and two decode steps
    on (2, 2) with explicit TP against the unsharded steps (float32;
    mixtral at capacity factor 8, where its sharded MoE drops nothing):
    samples within F32_REL, the cache placed by ``cache_specs`` and
    gathered equal."""
    cfg = dataclasses.replace(_f32(get_config(arch, smoke=True)),
                              explicit_tp=True, capacity_factor=8.0)
    prompt = cfg.ssm_chunk if cfg.family in ("ssm", "hybrid") else 12
    seq = prompt + 4                    # the cache's length
    batch = ttrain.build_batch(cfg, TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=prompt, global_batch=4), 0)
    batch.pop("labels")
    params = params_init(cfg, 0, "cpu")
    mesh = _cpu_mesh((2, 2))
    c0, s0 = tsteps.make_prefill_step(cfg, seq)(params, batch)
    pre, _ = tsteps.mesh_prefill_step(cfg, mesh, seq, 4)
    dec, _ = tsteps.mesh_decode_step(cfg, mesh, seq, 4)
    placed = S.place(params, S.param_specs, mesh)
    c1, s1 = pre(placed, batch)

    def close(a, b):
        assert float((a - b).abs().max()) <= F32_REL * float(b.abs().max())
    close(s1, s0)
    for x, spec in zip(leaves(c1), leaves(S.cache_specs(c1, mesh))):
        assert not isinstance(x, torch.Tensor)
        if isinstance(x, S.Placed):
            assert x.spec == spec.padded(x.ndim)
    for a, b in zip(leaves(S.gather(c1)), leaves(c0)):
        if isinstance(b, torch.Tensor):
            close(a, b)
    one = tsteps.make_decode_step(cfg)
    for t in range(2):
        tok = batch["tokens"][:, t:t + 1]
        s0, c0 = one(params, c0, tok)
        s1, c1 = dec(placed, c1, tok)
        close(s1, s0)
        assert c1["pos"] == c0["pos"]


# ----------------------------------------------------------------------
# Elastic re-meshing
# ----------------------------------------------------------------------
def test_train_state_continues_after_a_remesh():
    """A step on (2, 2), two coordinates lost, the state re-meshed:
    params bit-equal across the re-mesh, the count kept, and the next
    step equal to the same step on a fresh placement of the gathered
    state on the shrunken mesh (bit for bit) and within F32_LOSS_REL of
    the unbroken (2, 2) run's."""
    cfg = _f32(get_config("qwen3-0.6b", smoke=True))
    pipe = TokenPipelineConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)
    mesh = _cpu_mesh((2, 2))
    step, _ = tsteps.mesh_train_step(cfg, mesh, AdamWConfig(), 16, 4)
    params = params_init(cfg, 0, "cpu")
    opt = init_opt_state(params)
    params, opt, _ = step(params, opt, ttrain.build_batch(cfg, pipe, 0), 0)
    small = shrink_mesh(mesh, {(1, 0), (1, 1)})
    assert small.shape == {"data": 1, "model": 2}
    p2, o2 = remesh_train_state(params, opt, small)
    for a, b in zip(leaves(S.gather(p2)), leaves(S.gather(params))):
        assert torch.equal(a, b)
    assert int(S.gather(o2["count"])) == 1
    batch = ttrain.build_batch(cfg, pipe, 1)
    step2, _ = tsteps.mesh_train_step(cfg, small, AdamWConfig(), 16, 4)
    _, _, m_re = step2(p2, o2, batch, 1)
    _, _, m_fresh = step2(S.gather(params), S.gather(opt), batch, 1)
    _, _, m_on = step(params, opt, batch, 1)
    assert float(m_re["loss"]) == float(m_fresh["loss"])
    np.testing.assert_allclose(float(m_re["loss"]), float(m_on["loss"]),
                               rtol=F32_LOSS_REL)


# ----------------------------------------------------------------------
# The trainer, its CLI, the bridge
# ----------------------------------------------------------------------
def test_train_on_a_1x1_mesh_is_bit_equal():
    kw = dict(steps=2, batch=2, seq=16, device="cpu", log_every=100)
    a = ttrain.train("qwen3-0.6b", **kw)
    b = ttrain.train("qwen3-0.6b", mesh_shape=(1, 1), **kw)
    assert [h["loss"] for h in a["history"]] == [
        h["loss"] for h in b["history"]]
    for x, y in zip(leaves(a["params"]), leaves(b["params"])):
        assert torch.equal(x, y)
    for x, y in zip(leaves(a["opt"]), leaves(b["opt"])):
        assert torch.equal(x, y)


def test_train_cli_mesh(tmp_path):
    out = ttrain.main(["--arch", "qwen3-0.6b", "--device", "cpu", "--steps",
                       "2", "--batch", "4", "--seq", "16", "--mesh", "2x2",
                       "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every",
                       "1"])
    one = ttrain.train("qwen3-0.6b", steps=2, batch=4, seq=16, device="cpu")
    np.testing.assert_allclose([h["loss"] for h in out["history"]],
                               [h["loss"] for h in one["history"]],
                               rtol=BF16_LOSS_REL)
    assert all(not isinstance(x, S.Placed) for x in leaves(out["params"]))
    with pytest.raises(ValueError):
        ttrain.train("qwen3-0.6b", steps=1, batch=4, seq=16, device="cpu",
                     mesh_shape=(2, 2), compress=True)
    with pytest.raises(SystemExit):
        ttrain.main(["--arch", "qwen3-0.6b", "--devices", "cpu,cpu"])


def test_bridge_placed_round_trip():
    jp = bridge.to_numpy(params_init(get_config("mixtral-8x7b", smoke=True),
                                     0, "cpu"))
    mesh = _cpu_mesh((2, 2))
    placed = bridge.placed_from_jax(jp, S.param_specs, mesh)
    assert isinstance(placed["blocks"]["moe"]["wi"], S.Placed)
    back = bridge.placed_to_jax(placed)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))


# ----------------------------------------------------------------------
# Against the reference's sharded runs (the subprocess; last, so that
# the tests above run while it compiles)
# ----------------------------------------------------------------------
def test_make_debug_mesh_rule_matches_reference(spmd):
    want = spmd()["shapes"]
    for n in (1, 2, 3, 4, 6, 8):
        m = tmesh.make_debug_mesh(["cpu"] * n)
        assert [m.shape["data"], m.shape["model"]] == want[f"debug_{n}"]


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_sharded_moe_matches_reference(spmd, name):
    res = spmd()
    shape, e, cf = MOE_CASES[name]
    c = {k: torch.as_tensor(v) for k, v in res["inputs"][name].items()}
    mesh = _cpu_mesh(shape)
    stats = []
    moe = tmoe.make_sharded_moe(mesh, top_k=MOE_DIMS["k"],
                                capacity_factor=cf, n_experts=e,
                                dp_axes=("data",), stats=stats)
    y, aux = moe(c["x"], c["router"], c["wi"], c["wg"], c["wo"])
    out = res["out"]
    np.testing.assert_allclose(y.numpy(), out[f"moe_{name}_y"], rtol=0,
                               atol=MOE_ATOL)
    np.testing.assert_allclose(float(aux), float(out[f"moe_{name}_aux"]),
                               rtol=1e-6)
    assert len(stats) == shape[0] * shape[1]
    dropped = sum(s["local_pairs"] - s["kept"] for s in stats)
    y0, _ = tmoe.moe_apply(c["x"], c["router"], c["wi"], c["wg"], c["wo"],
                           top_k=MOE_DIMS["k"], capacity_factor=cf)
    np.testing.assert_allclose(y0.numpy(), out[f"moe_{name}_y_unsharded"],
                               rtol=0, atol=MOE_ATOL)
    if cf == 8.0:     # nothing drops: the sharded layer is moe_apply's
        assert dropped == 0
        np.testing.assert_allclose(y.numpy(), y0.numpy(), rtol=0,
                                   atol=MOE_ATOL)
    else:             # the row's capacity drops pairs, as the reference's
        assert dropped > 0
        if shape[0] > 1:  # rows: other pairs than the whole batch's
            assert float((y - y0).abs().max()) > MOE_ATOL


@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_mesh_train_step_matches_jit_train_step(spmd, tag):
    out = spmd()["out"]
    params, opt, losses = _run_mesh_steps(tag, out, "init_qwen3-0.6b")
    rel = BF16_LOSS_REL if tag == "bf16" else F32_LOSS_REL
    for s, m in enumerate(losses):
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(
                m[k], out[f"train_{tag}_{s}_{k}"], err_msg=f"{k} step {s}",
                rtol=BF16_GRAD_REL if (tag, k) == ("bf16", "grad_norm")
                else rel)
    assert int(S.gather(opt["count"])) == TRAIN_STEPS
    if tag != "bf16":
        want = _tree(out, f"after_{tag}")
        for a, b in zip(leaves(S.gather(params)), leaves(want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=F32_PARAM_ATOL)


def test_microbatches_4_against_1(spmd):
    out = spmd()["out"]
    _, _, l1 = _run_mesh_steps("bf16", out, "init_qwen3-0.6b")
    _, _, l4 = _run_mesh_steps("mb4", out, "init_qwen3-0.6b")
    for s in range(TRAIN_STEPS):
        assert abs(l1[s]["loss"] - l4[s]["loss"]) < MICROBATCH_ATOL
        for tag, got in (("bf16", l1), ("mb4", l4)):
            np.testing.assert_allclose(got[s]["loss"],
                                       out[f"train_{tag}_{s}_loss"],
                                       rtol=BF16_LOSS_REL)


def test_elastic_remesh_under_devices(spmd):
    """``tests/test_spmd.py:87-102``'s case over CPU coordinates, and
    the meshes' shapes equal to the reference's over its devices."""
    want = spmd()["shapes"]
    for n, lost in ELASTIC:
        m = make_elastic_mesh(["cpu"] * n)
        m2 = shrink_mesh(m, {m.coords()[i] for i in lost})
        assert [[m.shape["data"], m.shape["model"]],
                [m2.shape["data"], m2.shape["model"]]] == want[
            f"{n}_{lost}"]
    mesh = make_elastic_mesh(["cpu"] * 8)
    new_mesh = shrink_mesh(mesh, {mesh.coords()[-1], mesh.coords()[-2]})
    assert new_mesh.size <= 6
    params = {"w": torch.arange(64.0).reshape(8, 8)}
    opt = {"mu": {"w": torch.zeros(8, 8)}, "nu": {"w": torch.zeros(8, 8)},
           "count": torch.tensor(3, dtype=torch.int32)}
    p2, o2 = remesh_train_state(S.place(params, S.param_specs, mesh),
                                S.place(opt, S.opt_state_specs, mesh),
                                new_mesh)
    assert p2["w"].mesh is new_mesh
    assert torch.equal(S.gather(p2["w"]), params["w"])
    assert int(S.gather(o2["count"])) == 3
