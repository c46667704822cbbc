"""The least time each hand-written kernel's work could take on the card.

One count of each kernel's work: the bytes it must move (each input
read once, each output written once) and the float operations it must
do, with the integer ``hash3`` evaluations counted apart (they have no
peak rate in the table).  The bound is the larger of bytes over the
H100's memory rate and operations over its float32 rate.
``chip_smoke.py``'s kernel bounds and the engine's cost records
(``SarServingEngine.compiled_cost_records``, ``obs/prof.compiled_cost``)
both read these functions.  Pure host arithmetic on shapes: nothing
here touches a device.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_OPS_PER_S = 67e12             # H100 SXM, float32 outside tensor cores


def bound_line(nbytes: int, ops: int, hashes: int) -> dict:
    """{bound_ms, bound_by, bound_bytes, bound_ops, hash3_evals}."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_bytes": nbytes, "bound_ops": ops, "hash3_evals": hashes}


def decision_work(b: int, n: int, r: int, active: int, *,
                  sel_per_slot: bool, read_sigma: float = 0.0,
                  idx_per_slot: bool = False, rows: bool = False,
                  accumulate: bool = False) -> dict:
    """One decision round of ``r`` samples over ``b`` slots of ``n``
    classes, ``active`` of them unmasked.  A masked slot costs its mask
    byte and, for a delta launch, its zeroed outputs; an active slot
    also reads its rows of every per-slot input and writes its deltas,
    or, ``accumulate`` (the kernel's ``out=stats`` epilogue), reads and
    writes its 2·N + 2 running sums and a masked slot writes nothing.
    Per logit: the 16-term mix (32), −sum_mean·x_sigma (2), /sum_std +
    y_mu (2); softmax, entropy and the two sums (~8).  Read noise hashes
    one draw per (sample, active slot, class)."""
    per_slot = n * 4 * (2 + 16)                # y_mu, x_sigma, m rows
    shared = 0                                 # read once for all slots
    if sel_per_slot:
        per_slot += r * 16 * 4
    else:
        shared += r * 16 * 4
    if read_sigma > 0:
        per_slot += n * 4                      # x_sigsq
        if idx_per_slot:
            per_slot += r * 8
        else:
            shared += r * 8
        if rows:
            per_slot += 8
    stats = (2 * n + 2) * 4                    # sum_p, sum_psq, the two ent
    if accumulate:
        per_slot += stats
        writes = active * stats
    else:
        writes = b * stats
    reads = b + active * per_slot + shared     # mask: one byte a slot
    ops = r * active * n * 44
    hashes = r * active * n if read_sigma > 0 else 0
    return bound_line(reads + writes, ops, hashes)


def cim_work(m: int, k: int, n: int) -> dict:
    """One CIM product x [m, k] · w [k, n]: x, w, gain, offset and fs
    read once and out written once, against 2·M·K·N multiply-adds plus
    the front end and ADC of every chunk (gain·psum + offset·lsb,
    divide, round, two clamps, code·lsb, accumulate: 8 operations an
    output a chunk of 64)."""
    nbytes = 4 * (m * k + k * n + 2 * n + 1 + m * n)
    ops = 2 * m * k * n + 8 * m * n * (k // 64)
    return bound_line(nbytes, ops, 0)


def grng_bound(k: int, n: int, r: int, cfg) -> dict:
    """One ε block: sel read and ε written once, against its float
    operations: per current (i_lo+Δi·bit) + γ·gauss with the three-byte
    gauss (7; 6 more for an imprint term), per sample and cell the 16
    products and adds, the read noise (6) and the standardization (2).
    The integer hashing is counted apart."""
    per_current = 7 + (6 if cfg.imprint else 0)
    per_eps = 34 + (6 if cfg.read_sigma else 0)
    nbytes = 4 * (r * 16 + r * k * n)
    ops = k * n * 16 * per_current + r * k * n * per_eps
    hashes = k * n * 16 * (2 if cfg.imprint else 1) + (
        r * k * n if cfg.read_sigma else 0)
    return bound_line(nbytes, ops, hashes)


def head_bound(kind: str, b: int, k: int, n: int, r: int, cfg,
               wbytes: int = 4) -> dict:
    """One head product: x, µ', σ, sel (and fs) read and the [R, B, N]
    samples written once, against the float operations the function
    needs.  rank16: the 18 products 2BKN (x·µ', x·σ, 16 basis; a 19th
    for (x²)·(σ²) with read noise), the currents (7 a device, 1 more for
    σ·I_j) and per sample the 16-term mix and epilogue (36, and 8 more
    with read noise).  paper: x·µ' and one 2BKN product per sample, the
    currents, per sample and cell the ε sum (34, 6 more with read noise)
    and σ·ε; with the ADC (``paper_adc``) 6 operations a partial sum."""
    nbytes = wbytes * (b * k + 2 * k * n) + 4 * (r * 16 + r * b * n)
    currents = k * n * 16 * 8
    if kind == "rank16":
        noisy = bool(cfg.read_sigma)
        ops = (2 * b * k * n * (18 + noisy) + currents
               + r * b * n * (36 + 8 * noisy))
        hashes = k * n * 16 + (r * b * n if noisy else 0)
    else:
        per_eps = 35 + (6 if cfg.read_sigma else 0)
        ops = 2 * b * k * n * (1 + r) + currents + r * k * n * per_eps
        if kind == "paper_adc":
            nbytes += 8
            ops += 6 * b * n * -(-k // 64) * (1 + r)
        hashes = k * n * 16 + (r * k * n if cfg.read_sigma else 0)
    return bound_line(nbytes, ops, hashes)
