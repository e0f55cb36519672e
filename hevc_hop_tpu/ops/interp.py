"""HEVC motion-compensation interpolation filters, batched and bit-exact.

Capability ref: TComInterpolationFilter.cpp:49-87 (coefficient tables) and
the filter<N> template at :174 — two-stage separable filtering with 14-bit
intermediate precision (IF_INTERNAL_PREC), headroom-aware shifts/offsets.

Formulation: the per-block fractional phase selects a weight
vector (a gather from the coefficient table), and both separable stages run
as batched tensordot-style contractions over static window tensors. Running
the two-stage path unconditionally (phase 0 = [0, 64, 0, 0]) is bit-exact
with the reference's copy/single-stage shortcuts: with 8-bit video the
identity stage contributes exactly (x*64 - OFFS) and the final stage undoes
it ((64*t + OFFS*64 + 2048) >> 12 == x).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

IF_FILTER_PREC = 6
IF_INTERNAL_PREC = 14
IF_INTERNAL_OFFS = 1 << (IF_INTERNAL_PREC - 1)  # 8192

# TComInterpolationFilter.cpp:49 — 8-tap luma, quarter-pel phases 0..3
LUMA_FILTER = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], np.int32)

# TComInterpolationFilter.cpp:62 — 4-tap chroma, eighth-pel phases 0..7
CHROMA_FILTER = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], np.int32)


def filter_2d(window: jnp.ndarray, wh: jnp.ndarray, wv: jnp.ndarray,
              out_n: int, bit_depth: int = 8) -> jnp.ndarray:
    """Two-stage separable MC filter over batched windows.

    window: [B, out_n + T - 1, out_n + T - 1] int32 integer-pel samples,
    top-left at (target - (T/2 - 1)) for a T-tap filter.
    wh, wv: [B, T] int32 per-block horizontal/vertical coefficient rows.
    Returns [B, out_n, out_n] int32, clipped to bit_depth.
    """
    t = wh.shape[-1]
    headroom = IF_INTERNAL_PREC - bit_depth
    shift1 = IF_FILTER_PREC - headroom
    off1 = -(IF_INTERNAL_OFFS << shift1)
    shift2 = IF_FILTER_PREC + headroom
    off2 = (IF_INTERNAL_OFFS << IF_FILTER_PREC) + (1 << (shift2 - 1))

    # horizontal stage: [B, H, out_n] (HM: val = (sum + offset) >> shift)
    cols = jnp.stack([window[:, :, k:k + out_n] for k in range(t)], -1)
    mid = (jnp.sum(cols * wh[:, None, None, :], -1) + off1) >> shift1
    # vertical stage: [B, out_n, out_n]
    rows = jnp.stack([mid[:, k:k + out_n, :] for k in range(t)], -1)
    out = (jnp.sum(rows * wv[:, None, None, :], -1) + off2) >> shift2
    return jnp.clip(out, 0, (1 << bit_depth) - 1)


def chroma_mc(plane: jnp.ndarray, cpos: jnp.ndarray, mv_px: jnp.ndarray,
              m: int, h_clip: int, bit_depth: int = 8) -> jnp.ndarray:
    """Chroma MC for luma full-pel MVs (chroma phase 0 or 4 per axis).

    plane: [Hc(+pad), Wc] int32 recon; cpos: [B, 2] chroma block (x, y);
    mv_px: [B, 2] LUMA integer-pel motion (x, y); h_clip: last real chroma
    row + 1 (gathers clamp there = border extension). Returns [B, m, m].
    """
    cf = jnp.asarray(CHROMA_FILTER)
    mvc = mv_px >> 1                       # floor, chroma integer offset
    phase = (mv_px & 1) * 4                # 0 or 4 eighth-pel
    wh = cf[phase[:, 0]]
    wv = cf[phase[:, 1]]
    y0 = cpos[:, 1] + mvc[:, 1] - 1
    x0 = cpos[:, 0] + mvc[:, 0] - 1
    t = 4
    win = m + t - 1
    ry = y0[:, None, None] + jnp.arange(win)[None, :, None]
    rx = x0[:, None, None] + jnp.arange(win)[None, None, :]
    window = plane[jnp.clip(ry, 0, h_clip - 1),
                   jnp.clip(rx, 0, plane.shape[1] - 1)]
    return filter_2d(window, wh, wv, m, bit_depth)


def chroma_mc_q(plane: jnp.ndarray, cpos: jnp.ndarray, mv_qpel: jnp.ndarray,
                m: int, h_clip: int, bit_depth: int = 8) -> jnp.ndarray:
    """Chroma MC for quarter-pel luma MVs (full eighth-pel chroma phases,
    TComPrediction::xPredInterChromaBlk semantics: the luma quarter-pel MV
    value IS the chroma eighth-pel MV in 4:2:0).

    plane: [Hc(+pad), Wc] int32; cpos: [B, 2] chroma block (x, y);
    mv_qpel: [B, 2] LUMA quarter-pel motion. Returns [B, m, m].
    Bit-exact with chroma_mc when mv_qpel is a multiple of 4.
    """
    cf = jnp.asarray(CHROMA_FILTER)
    mvc = mv_qpel >> 3                     # chroma integer offset (floor)
    phase = mv_qpel & 7                    # eighth-pel phase
    wh = cf[phase[:, 0]]
    wv = cf[phase[:, 1]]
    y0 = cpos[:, 1] + mvc[:, 1] - 1
    x0 = cpos[:, 0] + mvc[:, 0] - 1
    t = 4
    win = m + t - 1
    ry = y0[:, None, None] + jnp.arange(win)[None, :, None]
    rx = x0[:, None, None] + jnp.arange(win)[None, None, :]
    window = plane[jnp.clip(ry, 0, h_clip - 1),
                   jnp.clip(rx, 0, plane.shape[1] - 1)]
    return filter_2d(window, wh, wv, m, bit_depth)


def luma_mc(plane: jnp.ndarray, pos: jnp.ndarray, mv_qpel: jnp.ndarray,
            n: int, h_clip: int, bit_depth: int = 8) -> jnp.ndarray:
    """Luma MC at quarter-pel precision (8-tap, TComInterpolationFilter
    filterHorLuma/filterVerLuma:335-385).

    plane: [H(+pad), W] int32; pos: [B, 2] block (x, y); mv_qpel: [B, 2]
    quarter-pel MV. h_clip: last readable row. Returns [B, n, n] int32.
    """
    lf = jnp.asarray(LUMA_FILTER)
    mvi = mv_qpel >> 2
    frac = mv_qpel & 3
    wh = lf[frac[:, 0]]
    wv = lf[frac[:, 1]]
    t = 8
    y0 = pos[:, 1] + mvi[:, 1] - (t // 2 - 1)
    x0 = pos[:, 0] + mvi[:, 0] - (t // 2 - 1)
    win = n + t - 1
    ry = y0[:, None, None] + jnp.arange(win)[None, :, None]
    rx = x0[:, None, None] + jnp.arange(win)[None, None, :]
    window = plane[jnp.clip(ry, 0, h_clip - 1),
                   jnp.clip(rx, 0, plane.shape[1] - 1)]
    return filter_2d(window, wh, wv, n, bit_depth)
