"""The port's fused decision update against the JAX reference.

On the CPU ``repro_torch.kernels.decision.decision_stats`` runs its plain
PyTorch version (the CUDA kernel itself is held against that version on
the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``).  Here
the port's ``ops.decision_update`` is compared with the reference's
Pallas kernel in interpret mode and with its oracle
``kernels/ref.decision_stats_ref``, at the shapes of
``tests/test_decision_kernel.py`` crossed with read noise and R, with
half the slots masked.  Both sides build their own basis from the same
numpy-seeded head and activations.

Tolerance rtol/atol 1e-5: the online and one-shot logsumexp sum in a
different order, and the mixed logits carry ~2 ulp of their terms.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clt_grng as jg
from repro.core import sampling as js
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serving import adaptive as jad
from repro.serving import triage as jtri
from repro_torch.core import clt_grng as tg
from repro_torch.core import sampling as ts
from repro_torch.kernels import decision as tdec
from repro_torch.kernels import ops as tops
from repro_torch.serving import adaptive as tad
from repro_torch.serving import triage as ttri

KEYS = ("sum_p", "sum_psq", "sum_ent", "sum_entsq", "n")


def _inputs(b, k, n, seed):
    rng = np.random.default_rng(seed)
    mu = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    sig = (np.log1p(np.exp(rng.standard_normal((k, n)) - 3)) * 0.2).astype(
        np.float32)
    return mu, sig, rng.standard_normal((b, k)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_basis_fn(read_sigma):
    gj = dataclasses.replace(jg.GRNGConfig(), read_sigma=read_sigma)
    hj = js.BayesHeadConfig(mode="rank16", grng=gj,
                            compute_dtype=jnp.float32, hoist_basis=True)
    return jax.jit(lambda mu, sig, x: js.activation_basis(
        js.prepare_serving_head(mu, sig, hj), x, hj)), gj


def _port_basis(b, k, n, read_sigma, seed=0):
    mu, sig, x = _inputs(b, k, n, seed)
    gt = tg.GRNGConfig(read_sigma=read_sigma)
    ht = ts.BayesHeadConfig(mode="rank16", grng=gt,
                            compute_dtype=torch.float32, hoist_basis=True)
    abt = ts.activation_basis(
        ts.prepare_serving_head(torch.as_tensor(mu), torch.as_tensor(sig),
                                ht), torch.as_tensor(x), ht)
    return abt, gt


def _bases(b, k, n, read_sigma, seed=0):
    """The same numpy-seeded head and activations through both packages."""
    fn, gj = _jax_basis_fn(read_sigma)
    abj = fn(*map(jnp.asarray, _inputs(b, k, n, seed)))
    abt, gt = _port_basis(b, k, n, read_sigma, seed)
    return abj, abt, gj, gt


def _port_round(b, r, n_drawn=0):
    base = torch.arange(b, dtype=torch.int64) * 100
    drawn = torch.full((b,), n_drawn, dtype=torch.int32)
    return (tad.stream_selections(tg.GRNGConfig(), base, drawn, r),
            tad.stream_indices(base, drawn, r))


def _round(b, r, n_drawn=0):
    """One round's selections and indices, reference and port (the
    integer streams are bit-equal, tests/test_torch_core.py)."""
    sel_t, idx_t = _port_round(b, r, n_drawn)
    return (jnp.asarray(sel_t.numpy()),
            jnp.asarray(idx_t.numpy().astype(np.uint32)), sel_t, idx_t)


def _assert_stats(got, want, keys=KEYS, atol=1e-5, msg=""):
    for key in keys:
        np.testing.assert_allclose(np.asarray(got[key]),
                                   np.asarray(want[key]), rtol=1e-5,
                                   atol=atol, err_msg=f"{msg}{key}")


@pytest.mark.parametrize("shape", [(5, 32, 8), (3, 16, 300), (9, 24, 130),
                                   (1, 8, 1)])
@pytest.mark.parametrize("read_sigma", [0.0, 0.4])
@pytest.mark.parametrize("r", [1, 6])
def test_decision_update_matches_reference(shape, read_sigma, r):
    b, k, n = shape
    abj, abt, gj, gt = _bases(b, k, n, read_sigma)
    sel_j, idx_j, sel_t, idx_t = _round(b, r)
    mask = np.arange(b) % 2 == 0
    got = tops.decision_update(tad.init_stats(b, n), abt, sel_t, gt,
                               sample_idx=idx_t,
                               mask=torch.as_tensor(mask))
    got = {k_: v.numpy() for k_, v in got.items()}
    kernel = jops.decision_update(jad.init_stats(b, n), abj, sel_j, gj,
                                  sample_idx=idx_j,
                                  mask=jnp.asarray(mask), interpret=True)
    oracle = jref.decision_stats_ref(abj["y_mu"], abj["x_sigma"], abj["m"],
                                     sel_j, gj, x_sigsq=abj.get("x_sigsq"),
                                     sample_idx=idx_j,
                                     mask=jnp.asarray(mask))
    _assert_stats(got, kernel, msg="pallas:")
    _assert_stats(got, oracle, keys=KEYS[:4], msg="oracle:")
    assert (got["n"][~mask] == 0).all() and (got["n"][mask] == r).all()
    assert (got["sum_p"][~mask] == 0).all()
    assert (got["sum_ent"][~mask] == 0).all()


def test_plain_version_is_update_stats_of_mix_samples():
    """decision_stats_plain == update_stats(init, mix_samples(...))
    inside the port, with a shared [R, 16] selection."""
    b, n, r = 4, 12, 5
    abt, gt = _port_basis(b, 16, n, 0.4, seed=3)
    hcfg = ts.BayesHeadConfig(mode="rank16", grng=gt,
                              compute_dtype=torch.float32)
    sel = tg.selections(gt, r)
    idx = torch.arange(r, dtype=torch.int64)
    want = tad.update_stats(tad.init_stats(b, n),
                            ts.mix_samples(abt, sel, hcfg, sample_idx=idx))
    got = tops.decision_update(tad.init_stats(b, n), abt, sel, gt,
                               sample_idx=idx)
    _assert_stats({k: v.numpy() for k, v in got.items()},
                  {k: v.numpy() for k, v in want.items()}, atol=1e-6)


@pytest.mark.parametrize("read_sigma", [0.0, 0.4])
def test_escalation_stream_extension_exact(read_sigma):
    """Two rounds at consecutive stream offsets accumulate the same
    statistics as one round over their union (as the reference's
    ``test_escalation_stream_extension_exact``)."""
    b, n = 5, 9
    abt, gt = _port_basis(b, 24, n, read_sigma, seed=1)
    sel_a, idx_a = _port_round(b, 4, n_drawn=0)
    sel_b, idx_b = _port_round(b, 8, n_drawn=4)
    sel_all, idx_all = _port_round(b, 12, n_drawn=0)
    stats = tops.decision_update(tad.init_stats(b, n), abt, sel_a, gt,
                                 sample_idx=idx_a)
    stats = tops.decision_update(stats, abt, sel_b, gt, sample_idx=idx_b)
    want = tops.decision_update(tad.init_stats(b, n), abt, sel_all, gt,
                                sample_idx=idx_all)
    _assert_stats({k: v.numpy() for k, v in stats.items()},
                  {k: v.numpy() for k, v in want.items()}, atol=1e-6)


def test_finalize_and_decide_match_reference():
    """finalize + decide (adaptive and fixed-R) on the same running sums,
    including empty slots and slots at the sample budget."""
    b, n = 9, 2
    abt, gt = _port_basis(b, 64, n, 0.0, seed=2)
    stats = tad.init_stats(b, n)
    for k_ in range(5):
        sel, idx = _port_round(b, 4, n_drawn=4 * k_)
        mask = torch.as_tensor(np.arange(b) >= k_)     # slot k_ stops early
        stats = tops.decision_update(stats, abt, sel, gt, sample_idx=idx,
                                     mask=mask)
    np_stats = {k_: v.numpy() for k_, v in stats.items()}
    fin_t = tad.finalize(stats)
    fin_j = jad.finalize({k_: jnp.asarray(v) for k_, v in np_stats.items()})
    for key in fin_j:
        np.testing.assert_allclose(fin_t[key].numpy(), np.asarray(fin_j[key]),
                                   rtol=1e-6, atol=1e-7, err_msg=key)
    for conf, mi in ((0.7, 0.05), (0.5, 0.7), (0.55, 0.01)):
        pj = jtri.TriagePolicy(conf_threshold=conf, mi_threshold=mi)
        pt = ttri.TriagePolicy(conf_threshold=conf, mi_threshold=mi)
        final_t = fin_t["n"] >= pt.r_max
        np.testing.assert_array_equal(
            ttri.decide(fin_t, pt, final=final_t).numpy(),
            np.asarray(jtri.decide(fin_j, pj,
                                   final=fin_j["n"] >= pj.r_max)))
        np.testing.assert_array_equal(
            ttri.fixed_r_decide(fin_t, pt).numpy(),
            np.asarray(jtri.fixed_r_decide(fin_j, pj)))
    assert tad.escalation_schedule(ttri.TriagePolicy()) == \
        jad.escalation_schedule(jtri.TriagePolicy())


def test_decision_stats_routes_by_device():
    """CPU tensors take the plain version and never count a launch; a
    device without a kernel raises instead of falling back."""
    abt, gt = _port_basis(3, 8, 4, 0.0)
    sel, _ = _port_round(3, 2)
    before = tdec.decision_stats.launches
    tdec.decision_stats(abt["y_mu"], abt["x_sigma"], abt["m"], sel, gt)
    assert tdec.decision_stats.launches == before
    meta = {k: v.to("meta") for k, v in abt.items()}
    with pytest.raises(ValueError, match="no decision kernel"):
        tdec.decision_stats(meta["y_mu"], meta["x_sigma"], meta["m"],
                            sel.to("meta"), gt)
