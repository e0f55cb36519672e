"""Scalar quantization / dequantization, batched and jittable.

Replaces TComTrQuant::xQuant / xDeQuant (TComTrQuant.cpp:993-1180) scalar
loops with whole-batch int32 tensor math. Dequant is normative (H.265 8.6.3,
flat scaling list m=16); forward quant follows HM's Q = (|c|*scale + off)>>qbits
dead-zone quantizer so coefficients match the reference encoder.

RDOQ (xRateDistOptQuant) is a separate, later op; this module is the plain
quantizer used by both and by the decoder-side dequant.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from hevc_hop_tpu.common import rom
from hevc_hop_tpu.common.types import COEF_MIN, COEF_MAX


def floor_log2(v: jnp.ndarray) -> jnp.ndarray:
    """Exact floor(log2(v)) of int32 v >= 1 (bit length - 1), by count of
    leading zeros: an encoder rate estimate then never depends on a
    backend's float log2."""
    return 31 - jax.lax.clz(v.astype(jnp.int32))


def quant(coef: jnp.ndarray, qp: int, log2_size: int, bit_depth: int = 8,
          is_intra_slice: bool = True) -> jnp.ndarray:
    """HM dead-zone quantizer. coef [..., N, N] int32 -> levels int32.

    qbits = QUANT_SHIFT + qp/6 + transformShift, offset 171/85 << (qbits-9)
    (intra/inter), exactly TComTrQuant.cpp:1040-1075.
    """
    qp = qp + 6 * (bit_depth - 8)   # QpBdOffset (H.265 8.6.1 QP'Y)
    per, rem = qp // 6, qp % 6
    tr_shift = rom.MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    qbits = rom.QUANT_SHIFT + per + tr_shift
    scale = int(rom.QUANT_SCALES[rem])
    offset = (171 if is_intra_slice else 85) << (qbits - 9)
    sign = jnp.sign(coef)
    level = (jnp.abs(coef) * scale + offset) >> qbits
    return jnp.clip(sign * level, COEF_MIN, COEF_MAX)


def dequant(level: jnp.ndarray, qp: int, log2_size: int,
            bit_depth: int = 8) -> jnp.ndarray:
    """Normative dequant, flat scaling (H.265 8.6.3 with m[x][y]=16).

    d = Clip3(-32768, 32767,
              ((level * 16 * levelScale[qp%6] << (qp/6)) + (1 << (bd-1))) >> bd)
    with bd = bitDepth + log2(nTbS) - 5.
    """
    qp = qp + 6 * (bit_depth - 8)   # QpBdOffset (H.265 8.6.1 QP'Y)
    per, rem = qp // 6, qp % 6
    bd_shift = bit_depth + log2_size - 5
    scale = (int(rom.INV_QUANT_SCALES[rem]) * 16) << per
    d = (level * scale + (1 << (bd_shift - 1))) >> bd_shift
    return jnp.clip(d, COEF_MIN, COEF_MAX)


def sbh_adjust(lev: jnp.ndarray, scan_id: jnp.ndarray,
               c_idx: int = 0, coef: jnp.ndarray | None = None,
               qp: int = 0, bit_depth: int = 8,
               lam: float = 0.0) -> jnp.ndarray:
    """Sign-bit-hiding parity enforcement (TComTrQuant.cpp:868
    signBitHidingHDQ analog, batched): for every 4x4 coefficient group
    where lastNZ-firstNZ >= 4 in scan order, the sign of the first nonzero
    is inferred by the decoder from the abs-level parity (HEVC 7.3.8.11) —
    when the parity disagrees with the real sign, one level is moved +-1.

    The position/direction is chosen by RD delta against the pre-quant
    transform coefficients `coef` (HM's deltaU minimization + the rate
    term of xRateDistOptQuant's sign-hiding stage): distortion delta in
    the coefficient domain plus lam-scaled level-rate delta (golomb-ish
    proxy for xGetICRate's +-1 cost). Excluded moves: a decrement that
    would zero the FIRST nonzero (hands the hidden sign to a different
    coefficient), and one that would zero the LAST nonzero when that
    collapses the span below 4 (hiding would be disabled and the sign
    coded anyway — the +-1 distortion would be pure loss).
    lev [B, N, N] int32; scan_id [B] MDCS scan.
    """
    b, n, _ = lev.shape
    log2 = n.bit_length() - 1
    m = n * n
    single = not (log2 == 2 or (log2 == 3 and c_idx == 0))
    flat = lev.reshape(b, m)
    if single:
        perm = jnp.broadcast_to(
            jnp.asarray(rom.scan_raster_index(log2, 0))[None], (b, m))
    else:
        perm_np = np.stack([rom.scan_raster_index(log2, s)
                            for s in (0, 1, 2)])
        perm = jnp.asarray(perm_np)[scan_id]
    c = jnp.take_along_axis(flat, perm, axis=1).reshape(b, m // 16, 16)
    a = jnp.abs(c)
    nz = c != 0
    idx = jnp.arange(16)
    first = jnp.min(jnp.where(nz, idx[None, None], 99), axis=-1)
    last = jnp.max(jnp.where(nz, idx[None, None], -1), axis=-1)
    hidden = (last - first) >= 4
    parity = (jnp.sum(a, -1) & 1) == 1
    vfirst = jnp.take_along_axis(
        c, jnp.clip(first, 0, 15)[..., None], -1)[..., 0]
    mism = hidden & (parity != (vfirst < 0))

    sgn = jnp.sign(c)
    if coef is None:
        # no distortion info: decrement the trailing nonzero
        tgt = jnp.clip(last, 0, 15)
        delta = jnp.where(mism, -jnp.take_along_axis(
            sgn, tgt[..., None], -1)[..., 0], 0)
        c = c + delta[..., None] * (idx[None, None] == tgt[..., None])
    else:
        cq = jnp.take_along_axis(coef.reshape(b, m), perm,
                                 axis=1).reshape(b, m // 16, 16)
        d_cur = (cq - dequant(c, qp, log2, bit_depth)).astype(jnp.float32)
        d_dec = (cq - dequant(c - sgn, qp, log2, bit_depth)
                 ).astype(jnp.float32)
        d_inc = (cq - dequant(c + sgn, qp, log2, bit_depth)
                 ).astype(jnp.float32)
        # lam-scaled level-rate delta in the coefficient-SSE domain
        # (distortion here is coef-domain: pixel SSE ~ coefSSE >> 2*trShift)
        tr_shift = rom.MAX_TR_DYNAMIC_RANGE - bit_depth - log2
        lamc = np.float32(lam * (4.0 ** tr_shift))
        gb = lambda v: jnp.where(
            v > 0, 1.0 + 2.0 * floor_log2(jnp.maximum(v, 1)).astype(
                jnp.float32), -1.5)
        r_cur = gb(a)
        r_dec = gb(a - 1)
        r_inc = gb(a + 1)
        cost_dec = (d_dec * d_dec - d_cur * d_cur
                    + lamc * (r_dec - r_cur))
        cost_inc = (d_inc * d_inc - d_cur * d_cur
                    + lamc * (r_inc - r_cur))
        big = jnp.float32(3e38)
        is_first = idx[None, None] == first[..., None]
        is_last = idx[None, None] == last[..., None]
        # second-to-last nonzero (for the span-collapse test)
        last2 = jnp.max(jnp.where(nz & ~is_last, idx[None, None], -1),
                        axis=-1)
        collapse = (last2 - first) < 4
        dec_ok = nz & ~((is_first | (is_last & collapse[..., None]))
                        & (a == 1))
        cost_dec = jnp.where(dec_ok, cost_dec, big)
        cost_inc = jnp.where(nz, cost_inc, big)
        use_dec = cost_dec <= cost_inc
        cost = jnp.minimum(cost_dec, cost_inc)        # [B, G, 16]
        tgt = jnp.argmin(cost, axis=-1)
        dirn = jnp.take_along_axis(use_dec, tgt[..., None], -1)[..., 0]
        st = jnp.take_along_axis(sgn, tgt[..., None], -1)[..., 0]
        delta = jnp.where(mism, jnp.where(dirn, -st, st), 0)
        c = c + delta[..., None] * (idx[None, None] == tgt[..., None])
    out = jnp.zeros_like(flat).at[
        jnp.arange(b)[:, None], perm].set(c.reshape(b, m))
    return out.reshape(b, n, n)
