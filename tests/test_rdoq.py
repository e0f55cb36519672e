"""RDOQ level-decision tests.

Oracle: the REAL entropy coder. For batches of transform blocks, RDOQ's
levels must win (or tie) the lambda-cost J = SSD + lambda*bits against the
plain dead-zone quantizer, where bits are actual CABAC bytes from the
native single-TU residual coder (residual_encode_one) and SSD is measured
after true dequant + inverse transform (the distortion the decoder sees).
Ref: TComTrQuant.cpp:1489 xRateDistOptQuant.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from hevc_hop_tpu.common import rom
from hevc_hop_tpu.entropy import ctx_layout, native
from hevc_hop_tpu.ops import quant, rdoq, transform


def _blocks(n, count, seed, amp, noise):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    out = []
    for s in range(count):
        r = (amp * np.sin(xx / (2.1 + s % 5) + s) * np.cos(yy / (3.3 + s % 3))
             + rng.normal(0, noise, (n, n)))
        out.append(r.astype(np.int32))
    return np.stack(out)


def _true_bits(lev, log2, c_idx, mode, states, lib):
    out = np.zeros(4096, np.uint8)
    nb = lib.residual_encode_one(states, np.ascontiguousarray(lev, np.int16),
                                 log2, c_idx, mode, out, out.size)
    assert nb > 0
    return 8 * int(nb)


@pytest.mark.parametrize("log2,qp", [(3, 27), (4, 32), (5, 37), (4, 22)])
def test_rdoq_beats_plain_quant_true_bits(log2, qp):
    n = 1 << log2
    lib = native.get_lib()
    states = ctx_layout.init_states(2, qp)  # I slice
    resi = _blocks(n, 24, seed=log2 * 10 + qp, amp=14, noise=7)
    coef = transform.fwd_transform(jnp.asarray(resi), 8, False)
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    lev_p = np.asarray(quant.quant(coef, qp, log2, 8, True))
    lev_r = np.asarray(rdoq.rdoq_quant(
        coef, jnp.zeros(resi.shape[0], jnp.int32), qp=qp, log2_size=log2,
        bit_depth=8, c_idx=0, init_type=2, lam=lam))

    def j_total(levels):
        deq = quant.dequant(jnp.asarray(levels), qp, log2, 8)
        rq = np.asarray(transform.inv_transform(deq, 8, False))
        ssd = float(((resi - rq).astype(np.float64) ** 2).sum())
        bits = sum(_true_bits(levels[i], log2, 0, 1, states, lib)
                   for i in range(levels.shape[0])
                   if levels[i].any())
        return ssd + lam * bits, ssd, bits

    jp, sp, bp = j_total(lev_p)
    jr, sr, br = j_total(lev_r)
    # RDOQ optimizes a MODEL of the adaptive coder; demand it not lose more
    # than 2% true-J (the realistic acceptance band). Note it may trade
    # MORE bits for distortion (round-half levels at low QP) or fewer at
    # high QP — only the combined J is the contract.
    assert jr <= jp * 1.02, (jr, jp, (sp, bp), (sr, br))


def test_rdoq_levels_bounded_and_signed():
    """Levels never exceed the round-half level and keep coef signs."""
    log2, qp, n = 4, 30, 16
    resi = _blocks(n, 16, seed=1, amp=20, noise=9)
    coef = np.asarray(transform.fwd_transform(jnp.asarray(resi), 8, False))
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    lev = np.asarray(rdoq.rdoq_quant(
        jnp.asarray(coef), jnp.zeros(16, jnp.int32), qp=qp, log2_size=log2,
        bit_depth=8, c_idx=0, init_type=2, lam=lam))
    per, rem = qp // 6, qp % 6
    qbits = rom.QUANT_SHIFT + per + (rom.MAX_TR_DYNAMIC_RANGE - 8 - log2)
    ld = np.abs(coef).astype(np.int64) * int(rom.QUANT_SCALES[rem])
    max_abs = (ld + (1 << (qbits - 1))) >> qbits
    assert (np.abs(lev) <= max_abs).all()
    assert ((lev == 0) | (np.sign(lev) == np.sign(coef))).all()


def test_rdoq_zero_input():
    lev = np.asarray(rdoq.rdoq_quant(
        jnp.zeros((4, 8, 8), jnp.int32), jnp.zeros(4, jnp.int32), qp=32,
        log2_size=3, bit_depth=8, c_idx=0, init_type=2, lam=10.0))
    assert not lev.any()


@pytest.mark.parametrize("formula", ["quant_sbh_rate", "rdoq_escape_len"])
def test_floor_log2_is_exact_bit_length(formula):
    """The integer bit length that replaced floor(log2(float)) in the SBH
    rate proxy (ops/quant.py) and the RDOQ escape length (ops/rdoq.py) is
    exact, and agrees with the old float formula except where that formula
    misrounded next to a power of two."""
    v = np.arange(1, (1 << 20) + 1, dtype=np.int32)
    new = np.asarray(quant.floor_log2(jnp.asarray(v)))
    exact = np.array([int(x).bit_length() - 1 for x in v])
    np.testing.assert_array_equal(new, exact)
    lg = jnp.log2(jnp.asarray(v).astype(jnp.float32))
    old = np.asarray(jnp.floor(lg if formula == "quant_sbh_rate"
                               else lg + 1e-6).astype(jnp.int32))
    bad = np.nonzero(old != exact)[0]
    assert len(bad) <= 4
    assert (np.abs(old[bad] - exact[bad]) == 1).all()
    near = np.abs(v[bad] - (1 << exact[bad]).astype(np.int64))
    near = np.minimum(near, np.abs((2 << exact[bad]).astype(np.int64)
                                   - v[bad]))
    assert (near <= 1).all(), v[bad]
