"""The LM trainer's step and infrastructure against the JAX reference,
on the CPU (SMOKE sizes).

  * ``launch/steps.make_train_step``: 3 steps of qwen3-0.6b SMOKE in
    float32 from bridged params and optimizer state, on the reference's
    own ``batch_at`` batches, against the reference's jitted step, with
    ``microbatches`` 1 and 2 and ``master_weights`` off and on.  Off:
    params within F32_PARAM_ATOL, metrics within F32_METRIC_RTOL (the
    float order of sums; ε one float32 step apart).  On (bf16 params,
    float32 master): params within one bf16 step (rtol 2^-7), the master
    within MASTER_ATOL and metrics within BF16_METRIC_RTOL: the params'
    bf16 KL and gradients round where XLA keeps float32 (measured:
    params one bf16 step, master 2.9e-5, loss 4.6e-6 relative).
  * ``make_prefill_step`` and ``make_decode_step`` (dense and audio
    SMOKE, float32) within F32_REL of the reference's.
  * ``optim/compression``: int8 codes and scales equal to the
    reference's (ties round half to even), the error state within one
    float32 step.
  * ``runtime/straggler``: the monitor's reports and events on
    synthetic timings equal, under each policy.
  * ``data/tokens.host_shard``, ``launch/steps.shape_adjusted_config``
    and ``input_specs``, ``configs/shapes``: equal.
  * the port's own ``train()``: resumed after ``--fail-at`` it equals
    an uninterrupted run bit for bit (params and the losses); the
    reference cannot be the oracle here (its restore meets ROADMAP
    C1's ``MemoryError``).  Every family trains two steps; ``--compress``
    leaves an error state; the CLI and its metrics lines; the card by
    default.
  * ``ckpt``: bfloat16 leaves round trip (stored as their 16-bit
    patterns), ``AsyncCheckpointer`` round trips and re-raises a failed
    write; the bridge's AdamW and error states.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import shapes as jshapes
from repro.data.tokens import TokenPipelineConfig as JPipe
from repro.data.tokens import batch_at as jbatch_at
from repro.data.tokens import host_shard as jhost_shard
from repro.launch import steps as jsteps
from repro.models.registry import get_api as jget_api
from repro.optim import AdamWConfig as JAdamW
from repro.optim import compression as jcomp
from repro.optim import init_opt_state as jinit_opt_state
from repro.runtime.straggler import StragglerConfig as JStragglerConfig
from repro.runtime.straggler import StragglerMonitor as JStragglerMonitor
from repro_torch import bridge
from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore, save
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs import shapes as tshapes
from repro_torch.data.tokens import host_shard
from repro_torch.kernels import bounds, grng
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.optim import AdamWConfig
from repro_torch.optim import compression as tcomp
from repro_torch.runtime import StragglerConfig, StragglerMonitor
from repro_torch.utils.trees import leaves

F32_PARAM_ATOL = 1e-6
F32_REL = 1e-5             # the serving steps: max error over max entry
F32_METRIC_RTOL = 1e-6
BF16_METRIC_RTOL = 1e-4
MASTER_ATOL = 1e-4
SMOKE_RUN = dict(batch=2, seq=16, device="cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


# ----------------------------------------------------------------------
# make_train_step against the reference's jitted step
# ----------------------------------------------------------------------
@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_train_step_matches_reference(microbatches, master):
    jc = dataclasses.replace(jget_config("qwen3-0.6b", smoke=True),
                             dtype=jnp.float32)
    tc = dataclasses.replace(get_config("qwen3-0.6b", smoke=True),
                             dtype=torch.float32)
    jp = jget_api(jc).init(jax.random.PRNGKey(0), jc)
    jo = jinit_opt_state(jp, master)
    if master:
        jp = jax.tree.map(lambda p: p.astype(jnp.bfloat16), jp)
    tp = bridge.lm_params_from_jax(jax.device_get(jp))
    to = bridge.lm_opt_state_from_jax(jax.device_get(jo))
    assert leaves(tp)[0].dtype == (torch.bfloat16 if master
                                   else torch.float32)
    kw = dict(total_steps=10, warmup_steps=2, microbatches=microbatches)
    jstep = jax.jit(jsteps.make_train_step(
        jc, JAdamW(master_weights=master), **kw))
    tstep = tsteps.make_train_step(tc, AdamWConfig(master_weights=master),
                                   **kw)
    pipe = JPipe(vocab=jc.vocab, seq_len=16, global_batch=4)
    rtol = BF16_METRIC_RTOL if master else F32_METRIC_RTOL
    for s in range(3):
        batch = jax.device_get(jbatch_at(pipe, s))
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tp, to, tm = tstep(tp, to, {k: torch.tensor(np.asarray(v))
                                    for k, v in batch.items()}, s)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=rtol, atol=1e-9, err_msg=k)
    assert int(to["count"]) == int(jo["count"]) == 3
    for want, got in zip(jax.tree_util.tree_leaves(jp), leaves(tp)):
        assert got.dtype == (torch.bfloat16 if master else torch.float32)
        want = np.asarray(jnp.asarray(want, jnp.float32))
        if master:
            np.testing.assert_allclose(_np(got), want, rtol=2**-7,
                                       atol=1e-30)
        else:
            np.testing.assert_allclose(_np(got), want, rtol=0,
                                       atol=F32_PARAM_ATOL)
    if master:
        for want, got in zip(jax.tree_util.tree_leaves(jo["master"]),
                             leaves(to["master"])):
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                       atol=MASTER_ATOL)
    back = bridge.lm_opt_state_to_jax(to)
    assert set(back) == set(jax.device_get(jo))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-medium"])
def test_prefill_and_decode_steps_match_reference(arch):
    """``make_prefill_step`` (the prompt's cache and its last position's
    logit samples) and ``make_decode_step`` against the reference's, in
    float32 from bridged params: within F32_REL of the largest entry."""
    jc = dataclasses.replace(jget_config(arch, smoke=True),
                             dtype=jnp.float32)
    tc = dataclasses.replace(get_config(arch, smoke=True),
                             dtype=torch.float32)
    jp = jget_api(jc).init(jax.random.PRNGKey(0), jc)
    tp = bridge.lm_params_from_jax(jax.device_get(jp))
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, jc.vocab, (2, 8)).astype(np.int32)}
    if jc.family == "audio":
        batch["frames"] = rng.standard_normal(
            (2, jc.n_frames, jc.d_model)).astype(np.float32)
    jcache, jsamples = jsteps.make_prefill_step(jc, 16)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tcache, tsamples = tsteps.make_prefill_step(tc, 16)(
        tp, {k: torch.tensor(v) for k, v in batch.items()})
    token = rng.integers(0, jc.vocab, (2, 1)).astype(np.int32)
    jnext, _ = jsteps.make_decode_step(jc)(jp, jcache, jnp.asarray(token))
    tnext, tcache2 = tsteps.make_decode_step(tc)(tp, tcache,
                                                 torch.tensor(token))
    assert tcache2["pos"] == tcache["pos"] + 1 == 9
    for want, got in ((jsamples, tsamples), (jcache["k"], tcache["k"]),
                      (jnext, tnext)):
        want = np.asarray(want)
        assert got.shape == want.shape
        err = np.abs(_np(got) - want).max()
        assert err <= F32_REL * max(np.abs(want).max(), 1e-3), err


# ----------------------------------------------------------------------
# compression, straggler, data and shapes
# ----------------------------------------------------------------------
def test_compression_matches_reference():
    rng = np.random.default_rng(0)
    grads = {"a": rng.standard_normal((6, 5)).astype(np.float32),
             "b": {"c": np.array([127.0, 2.5, -3.5, 0.5, 1.5, -0.5],
                                 np.float32),
                   "z": np.zeros((3,), np.float32)}}
    err = {"a": (1e-3 * rng.standard_normal((6, 5))).astype(np.float32),
           "b": {"c": np.zeros((6,), np.float32),
                 "z": np.zeros((3,), np.float32)}}
    jcompd, jerr = jcomp.compress_grads(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, err))
    tg = bridge.lm_params_from_jax(grads)
    terr = bridge.lm_params_from_jax(err)
    tcompd, tnew = tcomp.compress_grads(tg, terr)
    for path in (("a",), ("b", "c"), ("b", "z")):
        jc_, tc_ = jcompd, tcompd
        je, te = jerr, tnew
        for k in path:
            jc_, tc_, je, te = jc_[k], tc_[k], je[k], te[k]
        assert tc_[0].dtype == torch.int8
        np.testing.assert_array_equal(tc_[0].numpy(), np.asarray(jc_[0]))
        assert float(tc_[1]) == float(jc_[1])
        np.testing.assert_array_max_ulp(te.numpy(), np.asarray(je), 1)
    np.testing.assert_array_equal(tcompd["b"]["c"][0].numpy(),
                                  [127, 2, -4, 0, 2, 0])
    want, _ = jcomp.compressed_gradients(jax.tree.map(jnp.asarray, grads),
                                         jax.tree.map(jnp.asarray, err))
    got, _ = tcomp.compressed_gradients(tg, terr)
    for w, g in zip(jax.tree_util.tree_leaves(want), leaves(got)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    zero = tcomp.init_error_state(tg)
    assert all(float(z.abs().max()) == 0 and z.dtype == torch.float32
               for z in leaves(zero))


@pytest.mark.parametrize("policy", ["log", "rebatch", "exclude"])
def test_straggler_monitor_matches_reference(policy):
    durations = [1.0, 1.1, 0.9, 3.0, 3.5, 4.0, 1.0, 5.0, 1.2, 2.6, 2.7,
                 2.8, 2.9, 1.0, 0.95]
    jm = JStragglerMonitor(JStragglerConfig(policy=policy))
    tm = StragglerMonitor(StragglerConfig(policy=policy))
    for step, d in enumerate(durations):
        assert tm.end_step(step, d) == jm.end_step(step, d)
        assert tm.ema == jm.ema and tm.flags == jm.flags
    assert tm.events == jm.events and len(tm.events) >= 1
    assert tm.microbatch_share(8) == jm.microbatch_share(8)
    tm.start_step()
    assert tm.end_step(99)["duration"] >= 0


def test_host_shard_shapes_and_specs_match_reference():
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, 9, (10, 4)).astype(np.int32),
             "labels": rng.integers(0, 9, (10, 4)).astype(np.int32)}
    for host in range(3):
        want = jhost_shard(jax.tree.map(jnp.asarray, batch), host, 3)
        got = host_shard({k: torch.tensor(v) for k, v in batch.items()},
                         host, 3)
        for k in batch:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
    assert {k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    assert tshapes.LONG_CONTEXT_ARCHS == jshapes.LONG_CONTEXT_ARCHS
    for arch in ARCHS:
        assert tshapes.cells_for(arch) == jshapes.cells_for(arch)
        jc, tc = jget_config(arch), get_config(arch)
        for seq in (64, 448, 4096):
            ja = dataclasses.asdict(jsteps.shape_adjusted_config(jc, seq))
            ta = dataclasses.asdict(tsteps.shape_adjusted_config(tc, seq))
            ja.pop("dtype"), ta.pop("dtype")
            assert ja == ta
        for kind in ("train", "prefill", "decode"):
            want = jsteps.input_specs(jc, 128, 4, kind)
            got = tsteps.input_specs(tc, 128, 4, kind)
            assert list(got) == list(want)
            for k in want:
                assert got[k].shape == want[k].shape
                assert str(got[k].dtype).split(".")[-1] == \
                    str(want[k].dtype)
    assert tsteps.shape_adjusted_config(
        get_config("whisper-medium"), 4096).learned_pos == 4097
    with pytest.raises(ValueError):
        tsteps.input_specs(get_config("qwen3-0.6b"), 8, 1, "score")


def test_eps_launch_takes_the_vocabulary_width_block():
    """The ε kernel's one launch (checked before it is made) takes a
    head's training draw at every config's full width, and refuses a
    block past its grid."""
    for arch in ARCHS:
        cfg = get_config(arch)
        grng.check_block(1, cfg.d_model, cfg.vocab_padded)
    grng.check_block(1, grng.MAX_ROWS, grng.MAX_COLS)
    # the training draw's work at qwen3-0.6b's head, as chip_smoke.py
    # bounds it: 16 currents of 7 operations and a 34-operation sum a
    # cell, the 623 MB of ε written once
    cfg = get_config("qwen3-0.6b")
    ideal = dataclasses.replace(cfg.grng, read_sigma=0.0, imprint=0.0)
    work = bounds.grng_bound(cfg.d_model, cfg.vocab_padded, 1, ideal)
    assert (work["bound_bytes"], work["bound_ops"], work["hash3_evals"],
            work["bound_by"]) == (622854208, 22734176256, 2491416576,
                                  "operations")
    assert abs(work["bound_ms"] - 0.3393160635) < 1e-9
    for shape in ((1, grng.MAX_ROWS + 1, 8), (1, 8, grng.MAX_COLS + 1),
                  (0, 8, 8)):
        with pytest.raises(ValueError):
            grng.check_block(*shape)


# ----------------------------------------------------------------------
# the port's trainer
# ----------------------------------------------------------------------
def _same_params(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(leaves(a), leaves(b)))


def test_train_resume_is_bit_exact(tmp_path, capsys):
    whole = ttrain.train("qwen3-0.6b", steps=6, **SMOKE_RUN)
    ck = tmp_path / "ck"
    with pytest.raises(SystemExit, match="simulated failure at step 3"):
        ttrain.train("qwen3-0.6b", steps=6, ckpt_dir=str(ck), ckpt_every=2,
                     fail_at=3, **SMOKE_RUN)
    assert latest_step(ck) == 2
    resumed = ttrain.train("qwen3-0.6b", steps=6, ckpt_dir=str(ck),
                           ckpt_every=2, **SMOKE_RUN)
    assert "[train] resumed from step 2" in capsys.readouterr().out
    assert [h["step"] for h in resumed["history"]] == [2, 3, 4, 5]
    assert [h["loss"] for h in resumed["history"]] == \
        [h["loss"] for h in whole["history"][2:]]
    assert _same_params(resumed["params"], whole["params"])
    assert int(resumed["opt"]["count"]) == 6
    assert latest_step(ck) == 6
    tree, _ = restore(ck)
    assert _same_params(bridge.lm_params_from_jax(tree["params"]),
                        whole["params"])
    ce = [h["ce"] for h in whole["history"]]
    assert all(np.isfinite(ce)) and {"grad_norm", "lr", "kl", "aux",
                                     "step_time"} <= set(whole["history"][0])


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "whisper-medium",
                                  "llama-3.2-vision-11b", "mamba2-130m",
                                  "zamba2-2.7b"])
def test_every_family_trains(arch):
    out = ttrain.train(arch, steps=2, **SMOKE_RUN)
    assert len(out["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert all(torch.isfinite(p).all() for p in leaves(out["params"]))


def test_compressed_training_keeps_an_error_state():
    out = ttrain.train("qwen3-0.6b", steps=3, compress=True, **SMOKE_RUN)
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert max(float(e.abs().max()) for e in leaves(out["err"])) > 0
    assert ttrain.train("qwen3-0.6b", steps=1, **SMOKE_RUN)["err"] is None


def test_train_cli_writes_metrics(tmp_path, capsys):
    path = tmp_path / "m.jsonl"
    out = ttrain.main(["--arch", "mamba2-130m", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "16",
                       "--metrics", str(path)])
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [x["step"] for x in lines] == [0, 1]
    assert lines[-1]["loss"] == out["final_loss"]
    assert "[train] done, final loss" in capsys.readouterr().out


def test_trainer_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train("qwen3-0.6b", steps=1, batch=2, seq=16)


# ----------------------------------------------------------------------
# checkpoints and the bridge
# ----------------------------------------------------------------------
def _tree():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn((3, 4), generator=g).to(torch.bfloat16),
            "b": torch.randn((5,), generator=g),
            "n": {"count": torch.tensor(7, dtype=torch.int32),
                  "ids": np.arange(4, dtype=np.int64)}}


def test_bf16_checkpoint_round_trip(tmp_path):
    tree = _tree()
    save(tmp_path, 3, tree)
    back, step = restore(tmp_path)
    assert step == 3
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], tree["w"])
    np.testing.assert_array_equal(back["b"], tree["b"].numpy())
    assert back["n"]["count"].dtype == np.int32
    np.testing.assert_array_equal(back["n"]["ids"], np.arange(4))


def test_async_checkpointer_round_trip_and_errors(tmp_path):
    tree = _tree()
    ck = AsyncCheckpointer(tmp_path / "a", keep_last=2)
    for step in (1, 2, 3):
        ck.submit(step, tree)
    ck.wait()
    assert latest_step(tmp_path / "a") == 3
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == [
        "step_0000000002", "step_0000000003"]
    back, _ = restore(tmp_path / "a")
    assert torch.equal(back["w"], tree["w"])
    blocker = tmp_path / "file"
    blocker.write_text("")
    bad = AsyncCheckpointer(blocker / "sub")
    bad.submit(1, tree)
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()                          # the error is raised once


def test_bridge_carries_bf16_and_opt_states():
    jp = {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3) / 7}
    state = jax.device_get(jinit_opt_state(jp, master_weights=True))
    bf = jax.device_get(jax.tree.map(lambda p: p.astype(jnp.bfloat16), jp))
    tp = bridge.lm_params_from_jax(bf)
    assert tp["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(bridge.lm_params_to_jax(tp)["a"],
                                  np.asarray(bf["a"], np.float32))
    ts = bridge.lm_opt_state_from_jax(state)
    assert ts["count"].dtype == torch.int32 and "master" in ts
    back = bridge.lm_opt_state_to_jax(ts)
    for k in ("mu", "nu", "master"):
        np.testing.assert_array_equal(back[k]["a"], state[k]["a"])
