"""GT (geometric transform / HOP) warp prediction ops.

Capability ref: TComPrediction.cpp:723-960 — xPredGTLuma fetches a 2Wx2H
reference window centered on the SS vector target, derives a 3x3 homography
from 4 corner offset vectors (calcParamProjective:807 / calcParamBilinear:862)
and inverse-maps every pixel of the central WxH block with bilinear
interpolation (ProjectiveTransform:904), clamped to the NSS window.

Formulation: corner-candidate sets are batched — a single
gather+weighted-sum evaluates all warped blocks at once. The affine
restriction (IT_GT_AFFINE, TypeDef.h:212: only 3 corner vectors coded,
BL derived) makes every map coordinate an EXACT RATIONAL with denominator
D = 2*(grid-1), so the whole warp runs in int32 — deterministic and
platform-independent, unlike the reference's float64 path. The reference's
double arithmetic can only disagree with the exact rational result when a
truncation/rounding input lands exactly on a boundary (integer Fx/Fy, or
aux+0.5 exactly integral); `warp_blocks` returns a per-block safety mask
flagging those knife-edge blocks and the encoder demotes them to
translation, which guarantees the reference decoder reconstructs our GT
streams bit-exactly (tests/test_conformance_hm.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

GRID = 2  # IT_GT_GRID_SIZE (TypeDef.h:228): corner grid is 2x block size


def calc_param_projective(cx: jnp.ndarray, cy: jnp.ndarray,
                          gw: int, gh: int) -> jnp.ndarray:
    """Homography params from 4 corner points (batched, float32).

    Retained for analysis/tests; the production warp path is the exact
    integer formulation in warp_blocks. cx, cy: [..., 4] corner coords
    (TL, TR, BR, BL; ref xPredGTLuma corner setup). Returns h [..., 9]
    (Fx: h0,h3,h6; Fy: h1,h4,h7; denominator h2,h5,h8).
    """
    w = jnp.float32(gw - 1)
    h_ = jnp.float32(gh - 1)
    cx = cx.astype(jnp.float32)
    cy = cy.astype(jnp.float32)
    dx1 = cx[..., 1] - cx[..., 2]
    dx2 = cx[..., 3] - cx[..., 2]
    dx3 = cx[..., 0] - cx[..., 1] + cx[..., 2] - cx[..., 3]
    dy1 = cy[..., 1] - cy[..., 2]
    dy2 = cy[..., 3] - cy[..., 2]
    dy3 = cy[..., 0] - cy[..., 1] + cy[..., 2] - cy[..., 3]
    den = dx1 * dy2 - dx2 * dy1
    den = jnp.where(den == 0, 1e-9, den)
    h2 = ((dx3 * dy2 - dx2 * dy3) / den) / w
    h5 = ((dx1 * dy3 - dx3 * dy1) / den) / h_
    h0 = (cx[..., 1] - cx[..., 0]) / w + h2 * cx[..., 1]
    h3 = (cx[..., 3] - cx[..., 0]) / h_ + h5 * cx[..., 3]
    h6 = cx[..., 0]
    h1 = (cy[..., 1] - cy[..., 0]) / w + h2 * cy[..., 1]
    h4 = (cy[..., 3] - cy[..., 0]) / h_ + h5 * cy[..., 3]
    h7 = cy[..., 0]
    h8 = jnp.ones_like(h0)
    return jnp.stack([h0, h1, h2, h3, h4, h5, h6, h7, h8], axis=-1)


def corners_from_offsets(gt: jnp.ndarray, n: int) -> tuple:
    """Corner grid coordinates from 4 offset vectors.

    gt: [..., 4, 2] integer corner offset vectors (hor, ver), step 1.
    Block size n; grid is GRID*n. Ref xPredGTLuma corner setup
    (TComPrediction.cpp:758-764). Returns (cx [...,4], cy [...,4]).
    """
    g = GRID * n
    base_x = jnp.asarray([0, g - 1, g - 1, 0], jnp.int32)
    base_y = jnp.asarray([0, 0, g - 1, g - 1], jnp.int32)
    return (gt[..., 0] + base_x, gt[..., 1] + base_y)


def is_affine(h: jnp.ndarray, eps: float = 1e-9) -> jnp.ndarray:
    """IT_GT_AFFINE acceptance mask (TEncSearch.cpp:4905-4908)."""
    return (jnp.abs(h[..., 2]) <= eps) & (jnp.abs(h[..., 5]) <= eps)


def _trunc_div_tz(a: jnp.ndarray, d: int) -> jnp.ndarray:
    """C-style integer division (truncate toward zero)."""
    q = jnp.abs(a) // d
    return jnp.where(a < 0, -q, q).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("n", "bit_depth", "half"))
def warp_blocks(windows: jnp.ndarray, corners: jnp.ndarray, n: int,
                bit_depth: int = 8, half: bool = False):
    """Apply batched GT warps, exact integer arithmetic.

    windows: [B, 2n, 2n] int reference windows spanning grid coordinates
    [-n/2, 3n/2) per axis (the SS-target block at the center; margin = n/2
    = iNSSWindow/GRID). corners: [B, 4, 2] corner OFFSET vectors
    (TL, TR, BR, BL) in full-pel units, or half-pel units when half=True
    (the chroma path: coded luma corner vectors / 2).

    Returns (pred [B, n, n] int32, safe [B] bool). `safe` is False when any
    pixel's exact map coordinate or rounded output sits exactly on a
    truncation boundary — the only inputs where the reference's float64
    ProjectiveTransform may round the other way.
    """
    b = windows.shape[0]
    g = GRID * n
    w = g - 1
    d = 2 * w                       # common denominator (half-pel units x w)
    s = 1 if half else 2            # corner offsets -> half-pel units
    base_x = jnp.asarray([0, w, w, 0], jnp.int32) * 2
    base_y = jnp.asarray([0, 0, w, w], jnp.int32) * 2
    cx = corners[..., 0].astype(jnp.int32) * s + base_x     # [B, 4] 2x units
    cy = corners[..., 1].astype(jnp.int32) * s + base_y
    off = g // 2 - n // 2           # window offset of the central block

    xs = jnp.arange(off, off + n, dtype=jnp.int32)
    xg, yg = jnp.meshgrid(xs, xs, indexing="xy")
    xg, yg = xg[None], yg[None]                              # [1, n, n]

    c = lambda a, i: a[:, i, None, None]
    # Fx = ax/d, Fy = ay/d exactly (affine: h2 = h5 = 0)
    ax = ((c(cx, 1) - c(cx, 0)) * xg + (c(cx, 3) - c(cx, 0)) * yg
          + c(cx, 0) * w)
    ay = ((c(cy, 1) - c(cy, 0)) * xg + (c(cy, 3) - c(cy, 0)) * yg
          + c(cy, 0) * w)
    xt = _trunc_div_tz(ax, d)       # (Int)Fx, toward zero
    yt = _trunc_div_tz(ay, d)
    pn = ax - xt * d                # fraction numerators in (-d, d)
    qn = ay - yt * d
    xi = xt - off
    yi = yt - off

    nssg = n // 2                   # iNSSWindow / GRID
    lim = nssg + n - 1
    xu, yu = xi, yi                 # unclamped (for the safety analysis)
    xi = jnp.clip(xi, -nssg, lim - 1)   # the ref's two-stage clamp: X and
    yi = jnp.clip(yi, -nssg, lim - 1)   # X+1 both inside -> X <= lim-1

    margin = nssg
    bi = jnp.arange(b)[:, None, None]
    a00 = windows[bi, yi + margin, xi + margin]
    a01 = windows[bi, yi + margin, xi + 1 + margin]
    a10 = windows[bi, yi + 1 + margin, xi + margin]
    a11 = windows[bi, yi + 1 + margin, xi + 1 + margin]
    num = ((d - qn) * ((d - pn) * a00 + pn * a01)
           + qn * ((d - pn) * a10 + pn * a11))
    maxv = (1 << bit_depth) - 1
    num = jnp.clip(num, 0, maxv * d * d)
    pred = (2 * num + d * d) // (2 * d * d)     # (Pel)(aux + 0.5)

    # Knife edges where the reference's float64 may land on the other side
    # (its error ~1e-11 vs the exact-rational spacing >= 1/d^2 ~ 3e-4, so
    # ONLY exact boundary hits are ambiguous):
    #  - rounded output exactly between two integers (aux + 0.5 integral);
    #  - Fx/Fy exactly integral where the ref's trunc-toward-zero could
    #    yield the previous cell AND that changes the value class: negative
    #    coordinates (toward-zero trunc flips to an extrapolation weight)
    #    or a window-clamp boundary (different samples entirely). Interior
    #    positive integer hits only shift p: 0 vs ~1 on the previous cell,
    #    which converges to the same sample value.
    kx = (pn == 0) & ((ax < 0) | (xu <= -nssg) | (xu >= lim))
    ky = (qn == 0) & ((ay < 0) | (yu <= -nssg) | (yu >= lim))
    knife = kx | ky | ((2 * num + d * d) % (2 * d * d) == 0)
    safe = ~jnp.any(knife, axis=(1, 2))
    return pred.astype(jnp.int32), safe
