"""Batched intra prediction: all 35 HEVC modes for B same-size blocks at once.

Replaces the reference's per-PU scalar loops (TComPrediction.cpp
predIntraLumaAng/xPredIntraAng/xPredIntraPlanar, TComPattern.cpp
initAdiPattern/fillReferenceSamples) with a gather-based tensor formulation:

- reference samples live in a "chain" ref[4N+1] per block:
  index 0..2N-1   = left column bottom-to-top (left[2N-1] .. left[0])
  index 2N        = corner (above-left)
  index 2N+1..4N  = top row left-to-right (top[0] .. top[2N-1])
- substitution (H.265 8.4.4.2.2) is a running fill over the chain
- the 33 angular modes become one gather + lerp over a per-mode extended
  main reference, with static index/fraction tables; horizontal modes are
  produced by transposing the vertical formulation
- SATD-based RMD then reduces over the mode axis on-device

All arithmetic is int32, bit-exact with H.265 8.4.4.2.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from hevc_hop_tpu.common import rom

_FILTER_THRESH = {2: 10, 3: 7, 4: 1, 5: 0}


@functools.lru_cache(maxsize=None)
def _static_tables(n: int):
    """Precompute per-mode gather tables for an NxN block.

    Returns dict of numpy arrays:
      ext_idx[33, 3N+1]  chain indices building the extended main ref
      pred_idx[33, N, N] indices into the extended main ref
      fact[33, N]        interpolation fractions per row (vertical form)
      is_hor[33]         mode is horizontal family (output transposed)
      filt[33]           use filtered reference chain
    """
    log2 = n.bit_length() - 1
    thresh = _FILTER_THRESH[log2]
    ext_idx = np.zeros((33, 3 * n + 1), np.int32)
    pred_idx = np.zeros((33, n, n), np.int32)
    fact = np.zeros((33, n), np.int32)
    is_hor = np.zeros(33, bool)
    filt = np.zeros(33, bool)
    for mi in range(33):
        mode = mi + 2
        angle = int(rom.INTRA_PRED_ANGLE[mi])
        inv_angle = int(rom.INTRA_INV_ANGLE[mi])
        hor = mode < 18
        is_hor[mi] = hor
        dist = min(abs(mode - 26), abs(mode - 10))
        filt[mi] = dist > thresh
        # chain index helpers
        def left_c(y):  # left sample at row y; y=-1 -> corner
            return 2 * n - 1 - y
        def top_c(x):   # top sample at col x; x=-1 -> corner
            return 2 * n + 1 + x
        # main reference ref[i] = ext[n + i], i in [-n .. 2n]
        for i in range(0, 2 * n + 1):
            ext_idx[mi, n + i] = (top_c(i - 1) if not hor else left_c(i - 1))
        if angle < 0:
            for k in range(1, n + 1):
                j = ((-k * inv_angle + 128) >> 8) - 1
                # side reference: left for vertical family, top for horizontal
                ext_idx[mi, n - k] = (left_c(j) if not hor else top_c(j))
        # prediction gather (vertical formulation; horizontal transposed out)
        for y in range(n):
            off = ((y + 1) * angle) >> 5
            fact[mi, y] = ((y + 1) * angle) & 31
            for x in range(n):
                pred_idx[mi, y, x] = n + 1 + x + off
    return dict(ext_idx=ext_idx, pred_idx=pred_idx, fact=fact,
                is_hor=is_hor, filt=filt)


def substitute_refs(chain: jnp.ndarray, avail: jnp.ndarray,
                    bit_depth: int = 8) -> jnp.ndarray:
    """Reference substitution (H.265 8.4.4.2.2) over [B, 4N+1] chains."""
    length = chain.shape[-1]
    pos = jnp.arange(length, dtype=jnp.int32)
    idx = jnp.where(avail, pos, -1)
    prev = jax.lax.cummax(idx, axis=idx.ndim - 1)
    first = jnp.argmax(avail, axis=-1)
    gather = jnp.where(prev >= 0, prev, first[..., None])
    out = jnp.take_along_axis(chain, gather, axis=-1)
    any_avail = jnp.any(avail, axis=-1, keepdims=True)
    return jnp.where(any_avail, out, 1 << (bit_depth - 1))


def filter_refs(chain: jnp.ndarray, strong: bool = False,
                bit_depth: int = 8) -> jnp.ndarray:
    """1-2-1 smoothing (+ optional 32x32 strong bilinear smoothing)."""
    n = (chain.shape[-1] - 1) // 4
    inner = (chain[..., :-2] + 2 * chain[..., 1:-1] + chain[..., 2:] + 2) >> 2
    filt = jnp.concatenate(
        [chain[..., :1], inner, chain[..., -1:]], axis=-1)
    if strong and n == 32:
        # strong intra smoothing (8.4.4.2.3): bilinear if both edges flat
        thr = 1 << (bit_depth - 5)
        corner = chain[..., 2 * n]
        top_last = chain[..., 4 * n]
        left_last = chain[..., 0]
        top_mid = chain[..., 2 * n + n]      # top[N-1]
        left_mid = chain[..., n]             # left[N-1]
        cond = ((jnp.abs(corner + top_last - 2 * top_mid) < thr) &
                (jnp.abs(corner + left_last - 2 * left_mid) < thr))
        i = jnp.arange(63, dtype=jnp.int32)
        top_s = ((63 - i)[None] * corner[..., None]
                 + (i + 1)[None] * top_last[..., None] + 32) >> 6
        left_s = ((63 - i)[None] * corner[..., None]
                  + (i + 1)[None] * left_last[..., None] + 32) >> 6
        smooth = jnp.concatenate(
            [left_last[..., None], left_s[..., ::-1], corner[..., None],
             top_s, top_last[..., None]], axis=-1)
        filt = jnp.where(cond[..., None], smooth, filt)
    return filt


def predict_all_modes(chain_u: jnp.ndarray, n: int, c_idx: int = 0,
                      bit_depth: int = 8,
                      strong_smoothing: bool = True) -> jnp.ndarray:
    """All 35 intra predictions from substituted chains.

    chain_u: [B, 4N+1] int32 (already availability-substituted).
    Returns [B, 35, N, N] int32.
    """
    tabs = _static_tables(n)
    log2 = n.bit_length() - 1
    use_filter = c_idx == 0 and n > 4
    chain_f = filter_refs(chain_u, strong=strong_smoothing and c_idx == 0,
                          bit_depth=bit_depth) if use_filter else chain_u

    left = chain_u[..., 2 * n - 1::-1]          # left[0..2N-1]
    top = chain_u[..., 2 * n + 1:]              # top[0..2N-1]
    corner = chain_u[..., 2 * n]
    left_f = chain_f[..., 2 * n - 1::-1]
    top_f = chain_f[..., 2 * n + 1:]

    preds = []

    # ---- planar (8.4.4.2.4), uses filtered refs when filtering active ----
    pl, pt = (left_f, top_f) if use_filter else (left, top)
    x = jnp.arange(n, dtype=jnp.int32)
    y = jnp.arange(n, dtype=jnp.int32)
    planar = ((n - 1 - x)[None, None, :] * pl[:, :n, None]
              + (x + 1)[None, None, :] * pt[:, n, None, None]
              + (n - 1 - y)[None, :, None] * pt[:, None, :n]
              + (y + 1)[None, :, None] * pl[:, n, None, None]
              + n) >> (log2 + 1)
    preds.append(planar)

    # ---- DC (8.4.4.2.5), unfiltered refs ----
    dc = (jnp.sum(top[:, :n], axis=-1) + jnp.sum(left[:, :n], axis=-1)
          + n) >> (log2 + 1)
    dc_blk = jnp.broadcast_to(dc[:, None, None], planar.shape)
    if c_idx == 0 and n < 32:
        row0 = (top[:, :n] + 3 * dc[:, None] + 2) >> 2
        col0 = (left[:, :n] + 3 * dc[:, None] + 2) >> 2
        corner_val = (left[:, 0] + 2 * dc + top[:, 0] + 2) >> 2
        dc_blk = dc_blk.at[:, 0, :].set(row0)
        dc_blk = dc_blk.at[:, :, 0].set(col0)
        dc_blk = dc_blk.at[:, 0, 0].set(corner_val)
    preds.append(dc_blk)

    # ---- angular 2..34 via gather tables ----
    both = jnp.stack([chain_u, chain_f], axis=1)  # [B, 2, L]
    sel = jnp.asarray(tabs["filt"] & use_filter, jnp.int32)  # [33]
    ext_idx = jnp.asarray(tabs["ext_idx"])                   # [33, 3N+1]
    # ext[b, m, i] = both[b, sel[m], ext_idx[m, i]]
    ext = both[:, sel[:, None], ext_idx]                     # [B,33,3N+1]
    pidx = jnp.asarray(tabs["pred_idx"])                     # [33,N,N]
    f = jnp.asarray(tabs["fact"])[None, :, :, None]          # [1,33,N,1]
    g0 = jnp.take_along_axis(ext, pidx.reshape(1, 33, -1), axis=-1
                             ).reshape(-1, 33, n, n)
    g1 = jnp.take_along_axis(ext, (pidx + 1).reshape(1, 33, -1), axis=-1
                             ).reshape(-1, 33, n, n)
    ang = ((32 - f) * g0 + f * g1 + 16) >> 5
    # horizontal family: transpose
    is_hor = jnp.asarray(tabs["is_hor"])
    ang = jnp.where(is_hor[None, :, None, None],
                    jnp.swapaxes(ang, -1, -2), ang)

    # ---- edge filters for exact hor/ver, luma N<32 (8.4.4.2.6) ----
    if c_idx == 0 and n < 32:
        maxv = (1 << bit_depth) - 1
        # mode 26 = VER: column 0 adjusted
        v = ang[:, 24]  # mode 26 -> index 24
        col = jnp.clip(top[:, 0, None] + ((left[:, :n] - corner[:, None])
                                          >> 1), 0, maxv)
        ang = ang.at[:, 24].set(v.at[:, :, 0].set(col))
        # mode 10 = HOR: row 0 adjusted
        h = ang[:, 8]
        row = jnp.clip(left[:, 0, None] + ((top[:, :n] - corner[:, None])
                                           >> 1), 0, maxv)
        ang = ang.at[:, 8].set(h.at[:, 0, :].set(row))

    out = jnp.concatenate(
        [jnp.stack(preds, axis=1), ang], axis=1)
    return jnp.clip(out, 0, (1 << bit_depth) - 1)


def predict_mode(chain_u: jnp.ndarray, modes: jnp.ndarray, n: int,
                 c_idx: int = 0, bit_depth: int = 8,
                 strong_smoothing: bool = True) -> jnp.ndarray:
    """One intra prediction per block for a known mode vector.

    chain_u: [B, 4N+1] int32 (availability-substituted); modes: [B] int32.
    Returns [B, N, N] int32. ~12x less compute than predict_all_modes when
    the mode decision already happened (the coding wavefront's common case —
    TComPrediction.cpp predIntraLumaAng computes exactly one mode too).
    """
    tabs = _static_tables(n)
    log2 = n.bit_length() - 1
    use_filter = c_idx == 0 and n > 4
    chain_f = filter_refs(chain_u, strong=strong_smoothing and c_idx == 0,
                          bit_depth=bit_depth) if use_filter else chain_u

    left = chain_u[..., 2 * n - 1::-1]
    top = chain_u[..., 2 * n + 1:]
    corner = chain_u[..., 2 * n]
    left_f = chain_f[..., 2 * n - 1::-1]
    top_f = chain_f[..., 2 * n + 1:]

    pl, pt = (left_f, top_f) if use_filter else (left, top)
    x = jnp.arange(n, dtype=jnp.int32)
    y = jnp.arange(n, dtype=jnp.int32)
    planar = ((n - 1 - x)[None, None, :] * pl[:, :n, None]
              + (x + 1)[None, None, :] * pt[:, n, None, None]
              + (n - 1 - y)[None, :, None] * pt[:, None, :n]
              + (y + 1)[None, :, None] * pl[:, n, None, None]
              + n) >> (log2 + 1)

    dc = (jnp.sum(top[:, :n], axis=-1) + jnp.sum(left[:, :n], axis=-1)
          + n) >> (log2 + 1)
    dc_blk = jnp.broadcast_to(dc[:, None, None], planar.shape)
    if c_idx == 0 and n < 32:
        row0 = (top[:, :n] + 3 * dc[:, None] + 2) >> 2
        col0 = (left[:, :n] + 3 * dc[:, None] + 2) >> 2
        corner_val = (left[:, 0] + 2 * dc + top[:, 0] + 2) >> 2
        dc_blk = dc_blk.at[:, 0, :].set(row0)
        dc_blk = dc_blk.at[:, :, 0].set(col0)
        dc_blk = dc_blk.at[:, 0, 0].set(corner_val)

    # angular for this block's mode only
    mi = jnp.clip(modes - 2, 0, 32)
    b = chain_u.shape[0]
    both = jnp.stack([chain_u, chain_f], axis=1)            # [B, 2, L]
    sel = (jnp.asarray(tabs["filt"], jnp.int32)[mi]
           * jnp.int32(use_filter))                          # [B]
    ei = jnp.asarray(tabs["ext_idx"])[mi]                    # [B, 3N+1]
    ext = both[jnp.arange(b)[:, None], sel[:, None], ei]     # [B, 3N+1]
    pidx = jnp.asarray(tabs["pred_idx"])[mi]                 # [B, N, N]
    f = jnp.asarray(tabs["fact"])[mi][:, :, None]            # [B, N, 1]
    g0 = jnp.take_along_axis(ext, pidx.reshape(b, -1), axis=-1
                             ).reshape(b, n, n)
    g1 = jnp.take_along_axis(ext, (pidx + 1).reshape(b, -1), axis=-1
                             ).reshape(b, n, n)
    ang = ((32 - f) * g0 + f * g1 + 16) >> 5
    is_hor = jnp.asarray(tabs["is_hor"])[mi]
    ang = jnp.where(is_hor[:, None, None], jnp.swapaxes(ang, -1, -2), ang)

    if c_idx == 0 and n < 32:
        maxv = (1 << bit_depth) - 1
        col = jnp.clip(top[:, 0, None] + ((left[:, :n] - corner[:, None])
                                          >> 1), 0, maxv)
        ang = jnp.where((modes == 26)[:, None, None],
                        ang.at[:, :, 0].set(col), ang)
        row = jnp.clip(left[:, 0, None] + ((top[:, :n] - corner[:, None])
                                           >> 1), 0, maxv)
        ang = jnp.where((modes == 10)[:, None, None],
                        ang.at[:, 0, :].set(row), ang)

    out = jnp.where((modes == 0)[:, None, None], planar,
                    jnp.where((modes == 1)[:, None, None], dc_blk, ang))
    return jnp.clip(out, 0, (1 << bit_depth) - 1)


# ---------------------------------------------------------------------------
# SATD (Hadamard) cost for RMD, as exact s32 matmuls.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _hadamard(k: int) -> np.ndarray:
    h = np.array([[1]], np.int32)
    while h.shape[0] < k:
        h = np.block([[h, h], [h, -h]])
    return h


def satd(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Sum of absolute Hadamard-transformed differences over [..., N, N].

    Uses 8x8 Hadamard for N>=8 (HM RdCost convention: calcHAD uses 8x8
    blocks), 4x4 for N=4. Returns [...] int32.
    """
    n = a.shape[-1]
    k = 8 if n >= 8 else 4
    h = jnp.asarray(_hadamard(k))
    d = (a - b).astype(jnp.int32)
    # reshape into kxk tiles
    lead = d.shape[:-2]
    d = d.reshape(*lead, n // k, k, n // k, k)
    d = jnp.swapaxes(d, -3, -2)  # [..., n/k, n/k, k, k]
    t = jnp.einsum("ij,...jk,kl->...il", h, d, h,
                   preferred_element_type=jnp.int32)
    s = jnp.sum(jnp.abs(t), axis=(-1, -2))  # per tile
    if k == 8:
        s = (s + 2) >> 2
    else:
        s = (s + 1) >> 1
    return jnp.sum(s, axis=(-1, -2))
