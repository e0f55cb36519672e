"""ISS/PSS wavefront scan: joint intra / self-similarity encode + decode.

Capability ref: the reference's ISS slice machinery — the picture's causal
unfiltered recon is the sole L0 reference (TComSlice.cpp:366-377), full-
search ME over the causal area with validity filtering (TEncSearch.cpp:
6224,6262,6320-6340), per-CU recon copied into the SS ref (TEncCu.cpp:
870-880, TDecCu.cpp:454-476), intra/inter RD tournament (TEncCu.cpp:371).

Formulation (SURVEY.md §7.1): one lax.scan over topological wavefront
levels. Each step batches all ready CUs: 35-mode intra prediction AND a
dense SSE cost map over every causal displacement (a full-precision f32
correlation, `sse_map`), a static z-order causality mask instead of
NOT_VALID poisoning, joint mode selection, transform/quant/recon, scatter.
The SS reference is simply the recon carry — no separate poisoned
picture.

Scheduling: the encoder orders blocks so every z-earlier block within the
search reach is at a strictly earlier level (native wavefront_levels_ex,
ss_range); the decoder schedules by the *actual* coded MV dependency rects,
which is far more parallel.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from hevc_hop_tpu.models import partition, wavefront
from hevc_hop_tpu.ops import interp, intra, quant, rdoq, transform


def _mdcs_intra(inter, imode, n, c_idx=0):
    """[B] MDCS scan id: diag for inter blocks, mode-dependent for intra
    4x4 (any plane) / 8x8 luma (H.265 8.4.4.2.7)."""
    if not (n == 4 or (n == 8 and c_idx == 0)):
        return jnp.zeros(imode.shape, jnp.int32)
    s = jnp.where((imode >= 22) & (imode <= 30), 1,
                  jnp.where((imode >= 6) & (imode <= 14), 2, 0))
    return jnp.where(inter, 0, s).astype(jnp.int32)

IFM = 4          # luma margin covering the chroma MC filter reach
INTRA_BITS = 8.0  # flag + mode rate proxy for the SSE-domain tournament
INTER_BITS = 6.0  # skip/merge/inter flags + refidx proxy


# ---------------------------------------------------------------------------
# Host-side static schedule structures
# ---------------------------------------------------------------------------

def zmax_win_px(zaddr4: np.ndarray, n: int, ifm: int = IFM) -> np.ndarray:
    """Max z-address over every (n+2*ifm)-window, edge-extended.

    Indexed by the n-block target top-left (y, x) in [0, H-n] x [0, W-n];
    the ifm ring models the interpolation-filter margin (the reference's
    isValidPattern half-filter margin, TComRdCost.h:430-475) with border
    extension treated as its source edge sample.
    """
    zp = np.repeat(np.repeat(zaddr4, 4, 0), 4, 1)
    zp = np.pad(zp, ifm, mode="edge")
    k = n + 2 * ifm
    zr = sliding_window_view(zp, k, axis=1).max(-1)
    # z addresses fit int32 comfortably (ctu_index << 2*cshift | z)
    return np.ascontiguousarray(
        sliding_window_view(zr, k, axis=0).max(-1)).astype(np.int32)


def _mvd_bits(v: jnp.ndarray) -> jnp.ndarray:
    """Exact MVD bin count per component (quarter-pel units): the
    abs_mvd_greater0/greater1 flags + EG1 remainder + sign of codeMvd
    (TEncSbac.cpp:944), CABAC bins approximated at 1 bit each — the
    FAST_BIT_EST-style estimate of TComRdCost::getBits."""
    a = jnp.abs(v).astype(jnp.float32)
    return jnp.where(a == 0, 1.0,
                     jnp.where(a == 1, 3.0,
                               5.0 + 2.0 * jnp.floor(
                                   jnp.log2((a - 2.0) * 0.5 + 1.0))))


def _min_rate_bits(mvq: jnp.ndarray, preds: jnp.ndarray) -> jnp.ndarray:
    """Min MVD bits of mvq [B, K, 2] (qpel) over predictors [B, P, 2]."""
    bits = (_mvd_bits(mvq[:, :, None, 0] - preds[:, None, :, 0])
            + _mvd_bits(mvq[:, :, None, 1] - preds[:, None, :, 1]))
    return jnp.min(bits, axis=2)


def _dyn_rate_map(preds: jnp.ndarray, radius: int, lam: float) -> jnp.ndarray:
    """Per-block lambda-scaled rate map [B, D, D] (dy, dx; full-pel grid)
    from the dynamic predictor set [B, P, 2] (qpel; invalid predictors are
    encoded as huge sentinels so they never win the min). Replaces HM's
    per-candidate m_pcRdCost->getCost(x, y) inside xPatternSearch."""
    d4 = (4 * jnp.arange(-radius, radius + 1)).astype(jnp.int32)
    bx = _mvd_bits(d4[None, None, :] - preds[:, :, 0:1])   # [B, P, D]
    by = _mvd_bits(d4[None, None, :] - preds[:, :, 1:2])
    rm = jnp.min(by[:, :, :, None] + bx[:, :, None, :], axis=1)
    return lam * (INTER_BITS + rm)


def build_schedule_ss(blocks, w: int, h: int, ctb_log2: int, radius: int,
                      mv_rect: np.ndarray | None = None,
                      pad_steps: int = 32, pad_slots: int = 4):
    """Schedule tensors for ISS encode (radius > 0) or MV-aware decode
    (mv_rect given, radius == 0).

    Returns (sizes, data, nsteps); data[log2] has pos/valid/avail/availc as
    build_schedule plus zcur [S, B] int32 (-1 for padding dummies).
    Steps/slots are quantized to pad buckets so different per-frame
    quadtrees usually reuse one compiled scan program (advisor round-4:
    unbounded recompilation per partition).
    """
    from hevc_hop_tpu.entropy import native as _native
    arr = np.array(blocks, np.int32)
    levels = _native.wavefront_levels(
        arr[:, 0], arr[:, 1], arr[:, 2], w, h, ctb_log2,
        ss_range=(radius + IFM) if radius > 0 else 0, mv_rect=mv_rect)
    nsteps = int(levels.max()) if len(levels) else 0
    if pad_steps > 1:
        nsteps = max(pad_steps, -(-nsteps // pad_steps) * pad_steps)
    zplane = wavefront.zaddr4_plane(w, h, ctb_log2)
    czplane = zplane[::2, ::2]
    sizes = tuple(sorted({int(l) for l in arr[:, 2]}))
    data = {}
    order_all = {}
    for log2 in sizes:
        n = 1 << log2
        sel = arr[:, 2] == log2
        lv = levels[sel] - 1
        pts = arr[sel][:, :2]
        idx_orig = np.nonzero(sel)[0]
        counts = np.bincount(lv, minlength=nsteps)
        bmax = max(1, int(counts.max()))
        # SS slots are very expensive (full-search SSE maps per slot):
        # quantize lightly, scaled down further for big CUs
        slot_q = max(2, pad_slots >> max(log2 - 3, 0))
        if pad_slots > 1:
            bmax = max(slot_q, -(-bmax // slot_q) * slot_q)
        pos = np.zeros((nsteps, bmax, 2), np.int32)
        pos[:, :, 1] = h
        valid = np.zeros((nsteps, bmax), bool)
        src = np.full((nsteps, bmax), -1, np.int64)
        slot = np.zeros(nsteps, np.int32)
        for j in np.argsort(lv, kind="stable"):
            s = lv[j]
            pos[s, slot[s]] = pts[j]
            valid[s, slot[s]] = True
            src[s, slot[s]] = idx_orig[j]
            slot[s] += 1
        flat = pos.reshape(-1, 2)
        vmf = valid.reshape(-1)
        fv = flat[vmf]
        avail = np.zeros((flat.shape[0], 4 * n + 1), bool)
        avail[vmf] = wavefront.avail_mask(fv, n, zplane, w, h)
        availc = np.zeros((flat.shape[0], 2 * n + 1), bool)
        availc[vmf] = wavefront.avail_mask(fv // 2, n // 2, czplane,
                                           w // 2, h // 2)
        zcur = zplane[np.clip(pos[:, :, 1], 0, h - 1) >> 2,
                      np.clip(pos[:, :, 0], 0, w - 1) >> 2]
        zcur = np.where(valid, zcur, -1).astype(np.int32)
        # static z-availability of the five spatial merge/AMVP neighbor
        # positions A1, B1, B0, A0, B2 (TComDataCU::getInterMergeCandidates
        # order); whether the neighbor is *inter* is resolved on device.
        px_, py_ = pos[:, :, 0], pos[:, :, 1]
        nbx = np.stack([px_ - 1, px_ + n - 1, px_ + n, px_ - 1, px_ - 1], -1)
        nby = np.stack([py_ + n - 1, py_ - 1, py_ - 1, py_ + n, py_ - 1], -1)
        inf = (nbx >= 0) & (nby >= 0) & (nbx < w) & (nby < h)
        znb = zplane[np.clip(nby, 0, h - 1) >> 2, np.clip(nbx, 0, w - 1) >> 2]
        nbav = inf & (znb < zcur[..., None]) & valid[..., None]
        data[log2] = dict(
            pos=pos, valid=valid, zcur=zcur, src=src, nbav=nbav,
            avail=avail.reshape(nsteps, bmax, 4 * n + 1),
            availc=availc.reshape(nsteps, bmax, 2 * n + 1))
        order_all[log2] = idx_orig
    return sizes, data, nsteps


# ---------------------------------------------------------------------------
# On-device pieces
# ---------------------------------------------------------------------------

def _block_idx(pos, n):
    b = pos.shape[0]
    rows = pos[:, 1:2, None] + jnp.arange(n)[None, :, None]
    cols = pos[:, 0:1, None].transpose(0, 2, 1) + jnp.arange(n)[None, None, :]
    return (jnp.broadcast_to(rows, (b, n, n)),
            jnp.broadcast_to(cols, (b, n, n)))


def _gather_chains(plane, pos, n):
    coords = jnp.asarray(
        wavefront.chain_coords(np.zeros((1, 2), np.int64), n))[0]
    cx = pos[:, 0:1] + coords[None, :, 0]
    cy = pos[:, 1:2] + coords[None, :, 1]
    return plane[jnp.clip(cy, 0, plane.shape[0] - 1),
                 jnp.clip(cx, 0, plane.shape[1] - 1)]


def _search_window(plane, pos, n, radius, h):
    """[B, n+2r, n+2r] full-search windows around each block, edge-clamped
    to the picture (rows < h, so scratch rows are never read)."""
    wsz = n + 2 * radius
    ry = (pos[:, 1] - radius)[:, None, None] + jnp.arange(wsz)[None, :, None]
    rx = (pos[:, 0] - radius)[:, None, None] + jnp.arange(wsz)[None, None, :]
    return plane[jnp.clip(ry, 0, h - 1), jnp.clip(rx, 0, plane.shape[1] - 1)]


def sse_map(win, org):
    """SSE of every displacement: win [B, n+2r, n+2r], org [B, n, n] ->
    [B, 2r+1, 2r+1] float32 (dy, dx), as sum(org^2) + sum(ref^2) - 2 corr.

    The two correlations run as f32 convolutions at Precision.HIGHEST:
    the squared-sample terms reach 2^16 (8-bit) / 2^20 (10-bit), which a
    reduced-precision pass (TF32's 10-bit significand on the GPU's tensor
    cores) would round away. With full f32 every backend makes the same
    displacement choices up to summation order; sums above 2^24 still
    round, so the map is exact to a relative n^2 * 2^-23 of
    sum(org^2) + sum(ref^2). An encoder decision only: nothing normative
    depends on it."""
    n = org.shape[-1]
    wf = win.astype(jnp.float32)
    of = org.astype(jnp.float32)
    hi = jax.lax.Precision.HIGHEST

    def corr1(wv, kv):
        return jax.lax.conv_general_dilated(
            wv[None, None], kv[None, None], (1, 1), "VALID",
            precision=hi, preferred_element_type=jnp.float32)[0, 0]

    corr = jax.vmap(corr1)(wf, of)
    ones = jnp.ones((n, n), jnp.float32)
    ref2 = jax.lax.conv_general_dilated(
        (wf * wf)[:, None], ones[None, None], (1, 1), "VALID",
        precision=hi, preferred_element_type=jnp.float32)[:, 0]
    org2 = jnp.sum(of * of, axis=(1, 2))[:, None, None]
    return org2 + ref2 - 2.0 * corr


def _ss_search(recon, org, pos, zcur, zmaxw, rate_map, n, radius, w, h,
               zmax2n=None):
    """Masked full-search SSE cost map.

    rate_map: [B, D, D] per-block lambda-scaled rate (see _dyn_rate_map).
    Returns (mv_px [B,2], cost [B], pred [B,n,n], sse [B],
    gt_anchor [B,2], gt_rate [B], gt_any [B]): the gt_* outputs are the
    best displacement whose whole 2n GT window is causal (the anchor set
    of xPatternSearchGT, TEncSearch.cpp:5093-5141) when zmax2n is given.
    """
    b = pos.shape[0]
    d = 2 * radius + 1
    # causal validity of each displacement
    dr = jnp.arange(-radius, radius + 1)
    ty = pos[:, 1, None, None] + dr[None, :, None]
    tx = pos[:, 0, None, None] + dr[None, None, :]
    inb = (ty >= 0) & (tx >= 0) & (ty + n <= h) & (tx + n <= w)
    tyc = jnp.clip(ty, 0, h - n)
    txc = jnp.clip(tx, 0, w - n)
    zm = zmaxw[tyc, txc]
    mask = inb & (zm < zcur[:, None, None])

    win = _search_window(recon, pos, n, radius, h)
    sse = sse_map(win, org)

    big = jnp.float32(3.0e38)
    cost = jnp.where(mask, sse + rate_map, big)
    flat = cost.reshape(b, -1)
    idx = jnp.argmin(flat, axis=1)
    best = jnp.take_along_axis(flat, idx[:, None], 1)[:, 0]
    sse_best = jnp.take_along_axis(sse.reshape(b, -1), idx[:, None], 1)[:, 0]
    # fully-masked block (no causal candidate at all): poison the SSE too
    # so downstream refinement cannot resurrect the garbage argmin MV
    sse_best = jnp.where(best < jnp.float32(1e37), sse_best, big)
    mvy = (idx // d).astype(jnp.int32) - radius
    mvx = (idx % d).astype(jnp.int32) - radius
    # prediction = full-pel slice out of the gathered window
    ar = jnp.arange(n)
    pry = (mvy + radius)[:, None, None] + ar[None, :, None]
    prx = (mvx + radius)[:, None, None] + ar[None, None, :]
    bi = jnp.arange(b)[:, None, None]
    pred = win[bi, pry, prx]
    mv = jnp.stack([mvx, mvy], -1)

    if zmax2n is None:
        zero2 = jnp.zeros((b, 1, 2), jnp.int32)
        return (mv, best, pred, sse_best, zero2,
                jnp.zeros((b, 1), jnp.float32), jnp.zeros((b, 1), bool))

    # GT anchor ring: the K best displacements whose full 2n window
    # (+2 px chroma slack) is causal and in-frame — the anchor set of
    # xPatternSearchGT (ssBestCand ring + predictors,
    # TEncSearch.cpp:5093-5141); the caller may append AMVP-predictor
    # anchors via ss_anchor_ok
    wyy = ty - n // 2
    wxx = tx - n // 2
    inb2 = ((wxx >= 2) & (wyy >= 2)
            & (wxx + 2 * n + 2 <= w) & (wyy + 2 * n + 2 <= h))
    zm2 = zmax2n[jnp.clip(wyy, 0, h - 2 * n), jnp.clip(wxx, 0, w - 2 * n)]
    mask2 = inb2 & (zm2 < zcur[:, None, None])
    cost2 = jnp.where(mask2, sse + rate_map, big).reshape(b, -1)
    k = 1   # IT_SS_NUMBER_OF_BEST_CAND (TypeDef.h:218) + the predictor
    #         anchor appended by _gt_arm (IT_SS_USE_PREDICTORS)
    negc, idx2 = jax.lax.top_k(-cost2, k)          # [B, K]
    gt_ok = (-negc) < jnp.float32(1e37)
    gt_rate = jnp.take_along_axis(rate_map.reshape(b, -1), idx2, 1)
    amvy = (idx2 // d).astype(jnp.int32) - radius
    amvx = (idx2 % d).astype(jnp.int32) - radius
    anchors = jnp.stack([amvx, amvy], -1)          # [B, K, 2]
    return mv, best, pred, sse_best, anchors, gt_rate, gt_ok


def ss_anchor_ok(pos, zcur, zmax2n, disp, n, w, h):
    """Causal 2n-window validity of an arbitrary full-pel displacement
    [B, 2] (the AMVP-predictor anchor channel)."""
    wxx = pos[:, 0] + disp[:, 0] - n // 2
    wyy = pos[:, 1] + disp[:, 1] - n // 2
    inb2 = ((wxx >= 2) & (wyy >= 2)
            & (wxx + 2 * n + 2 <= w) & (wyy + 2 * n + 2 <= h))
    zm2 = zmax2n[jnp.clip(wyy, 0, h - 2 * n), jnp.clip(wxx, 0, w - 2 * n)]
    return inb2 & (zm2 < zcur)


def _t_search(refp, org, pos, rate_map, n, radius, w, h):
    """Temporal full-search on a (static) reference plane — the plain
    xPatternSearch (TEncSearch.cpp:6262) without causality masking.
    rate_map: [B, D, D]. Returns (mv_px [B,2], cost [B], pred [B,n,n],
    sse [B])."""
    b = pos.shape[0]
    d = 2 * radius + 1
    dr = jnp.arange(-radius, radius + 1)
    ty = pos[:, 1, None, None] + dr[None, :, None]
    tx = pos[:, 0, None, None] + dr[None, None, :]
    mask = (ty >= 0) & (tx >= 0) & (ty + n <= h) & (tx + n <= w)

    win = _search_window(refp, pos, n, radius, h)
    sse = sse_map(win, org)

    big = jnp.float32(3.0e38)
    cost = jnp.where(mask, sse + rate_map, big).reshape(b, -1)
    idx = jnp.argmin(cost, axis=1)
    best = jnp.take_along_axis(cost, idx[:, None], 1)[:, 0]
    sse_best = jnp.take_along_axis(sse.reshape(b, -1), idx[:, None], 1)[:, 0]
    sse_best = jnp.where(best < jnp.float32(1e37), sse_best, big)
    mvy = (idx // d).astype(jnp.int32) - radius
    mvx = (idx % d).astype(jnp.int32) - radius
    ar = jnp.arange(n)
    pry = (mvy + radius)[:, None, None] + ar[None, :, None]
    prx = (mvx + radius)[:, None, None] + ar[None, None, :]
    bi = jnp.arange(b)[:, None, None]
    pred = win[bi, pry, prx]
    return jnp.stack([mvx, mvy], -1), best, pred, sse_best


# ---------------------------------------------------------------------------
# Merge arms, dynamic-rate predictors, fractional-pel refinement
# ---------------------------------------------------------------------------

_HUGE_PRED = 1 << 19   # sentinel predictor coordinate: never wins a min


def _gather_cands(mvx4, mvy4, pi4, rf4, pos, nbav, miav, n: int,
                  mi_size: int, ss_idx: int):
    """Gather merge/AMVP raw material from the carried motion planes.

    Known approximation (advisor round-4): the static nbav availability
    can mark a SAME-wavefront-step neighbor available before its motion
    carry is written this step, so the encoder may see zero motion for it
    and mildly under-rate merge/AMVP candidates. Encoder-side only — the
    native serializer re-derives predictors from the final maps, so
    streams stay decoder-consistent.

    Candidate order: five spatial neighbors A1, B1, B0, A0, B2
    (TComDataCU::getInterMergeCandidates, TComDataCU.cpp:2761), three MI
    candidates (getMILeftCand/Above/AboveLeft, :2642-2712), zero. Returns
    (cands [B,9,2] qpel, cref [B,9], cvalid [B,9], preds_ss [B,6,2],
    preds_t [B,3,2]); preds_* feed the dynamic MVD-rate model (fillMvpCand
    analog), invalid slots pushed to a huge sentinel."""
    b = pos.shape[0]
    px, py = pos[:, 0], pos[:, 1]
    nx = jnp.stack([px - 1, px + n - 1, px + n, px - 1, px - 1], 1)
    ny = jnp.stack([py + n - 1, py - 1, py - 1, py + n, py - 1], 1)
    hp, wp = pi4.shape
    gy = jnp.clip(ny, 0, hp * 4 - 1) // 4
    gx = jnp.clip(nx, 0, wp * 4 - 1) // 4
    sp_mv = jnp.stack([mvx4[gy, gx], mvy4[gy, gx]], -1)
    sp_ref = rf4[gy, gx]
    sp_ok = nbav & (pi4[gy, gx] == 1)

    dmi = -(((n + mi_size - 1) // mi_size) * mi_size) * 4 if mi_size else 0
    mi_mv = jnp.broadcast_to(
        jnp.asarray([[dmi, 0], [0, dmi], [dmi, dmi]], jnp.int32)[None],
        (b, 3, 2))
    mi_ok = miav if mi_size > 0 else jnp.zeros((b, 3), bool)
    mi_ref = jnp.full((b, 3), ss_idx, jnp.int32)
    zero_mv = jnp.zeros((b, 1, 2), jnp.int32)
    cands = jnp.concatenate([sp_mv, mi_mv, zero_mv], 1)
    cref = jnp.concatenate(
        [sp_ref.astype(jnp.int32), mi_ref, jnp.zeros((b, 1), jnp.int32)], 1)
    cvalid = jnp.concatenate([sp_ok, mi_ok, jnp.ones((b, 1), bool)], 1)

    a1b1 = sp_mv[:, :2]
    big = jnp.int32(_HUGE_PRED)
    a1b1_ss = sp_ok[:, :2] & (sp_ref[:, :2] == ss_idx)
    a1b1_t = sp_ok[:, :2] & (sp_ref[:, :2] != ss_idx)
    p_ss = jnp.concatenate([
        jnp.where(a1b1_ss[..., None], a1b1, big),
        jnp.where(mi_ok[..., None], mi_mv, big), zero_mv], 1)
    p_t = jnp.concatenate([
        jnp.where(a1b1_t[..., None], a1b1, big), zero_mv], 1)
    return cands, cref, cvalid, p_ss, p_t


def _merge_arms(carry_y, ref_y, of, pos, zcur, zmaxw, cands, cref, cvalid,
                ss_idx: int, n: int, w: int, h: int, bit_depth: int,
                lam: float):
    """Prediction-domain RD of coding each merge candidate
    (xCheckRDCostMerge2Nx2N with the SS causal-validity veto,
    TEncCu.cpp:1243,1301-1330): exact qpel MC + merge-idx rate.
    Returns (cost [B], mv [B,2] qpel, ref [B], pred [B,n,n])."""
    b, k = cands.shape[:2]
    posr = jnp.repeat(pos, k, axis=0)
    mvf = cands.reshape(-1, 2)
    p_ss = interp.luma_mc(carry_y, posr, mvf, n, h,
                          bit_depth).reshape(b, k, n, n)
    is_ss = cref == ss_idx
    if ref_y is not None:
        p_t = interp.luma_mc(ref_y, posr, mvf, n, h,
                             bit_depth).reshape(b, k, n, n)
        pred = jnp.where(is_ss[..., None, None], p_ss, p_t)
    else:
        pred = p_ss
    mvi = cands >> 2
    tx = pos[:, None, 0] + mvi[..., 0]
    ty = pos[:, None, 1] + mvi[..., 1]
    inb = (tx >= 0) & (ty >= 0) & (tx + n <= w) & (ty + n <= h)
    zm = zmaxw[jnp.clip(ty, 0, h - n), jnp.clip(tx, 0, w - n)]
    causal = inb & (zm < zcur[:, None])
    ok = cvalid & jnp.where(is_ss, causal, True)
    sse = jnp.sum((of[:, None] - pred.astype(jnp.float32)) ** 2, (2, 3))
    idx_bits = jnp.minimum(jnp.arange(k) + 1, 4).astype(jnp.float32)
    cost = jnp.where(ok, sse + lam * (4.0 + idx_bits[None]),
                     jnp.float32(3e38))
    best = jnp.argmin(cost, 1)
    bc = jnp.take_along_axis(cost, best[:, None], 1)[:, 0]
    mv = jnp.take_along_axis(cands, best[:, None, None], 1)[:, 0]
    ref = jnp.take_along_axis(cref, best[:, None], 1)[:, 0]
    prd = jnp.take_along_axis(pred, best[:, None, None, None], 1)[:, 0]
    return bc, mv, ref, prd


_FRAC_OFFS = np.array([(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                       if (dx, dy) != (0, 0)], np.int32)


def _frac_refine(plane, of, pos, mvq0, pred0, sse0, preds, n: int, h: int,
                 bit_depth: int, lam: float):
    """Half- then quarter-pel refinement around the integer-pel best
    (xPatternSearchFracDIF, TEncSearch.cpp:6564), batched: each stage
    evaluates the 8 surrounding positions through the exact qpel MC path
    and keeps the RD best (SSE + dynamic MVD rate). The +-0.75 px reach
    stays inside the IFM causality ring validated by the integer search.
    Returns (mvq [B,2], pred [B,n,n], sse [B], cost [B])."""
    b = pos.shape[0]
    offs = jnp.asarray(_FRAC_OFFS)
    k = offs.shape[0]
    rate0 = _min_rate_bits(mvq0[:, None], preds)[:, 0]
    best_cost = sse0 + lam * (INTER_BITS + rate0)
    best_mv, best_pred, best_sse = mvq0, pred0, sse0
    posr = jnp.repeat(pos, k, axis=0)
    for step in (2, 1):
        cands = best_mv[:, None] + offs[None] * step
        pk = interp.luma_mc(plane, posr, cands.reshape(-1, 2), n, h,
                            bit_depth).reshape(b, k, n, n)
        sse = jnp.sum((of[:, None] - pk.astype(jnp.float32)) ** 2, (2, 3))
        cost = sse + lam * (INTER_BITS + _min_rate_bits(cands, preds))
        # an invalid base (fully-masked integer search) stays invalid
        cost = jnp.where(sse0[:, None] < jnp.float32(1e37), cost,
                         jnp.float32(3e38))
        ci = jnp.argmin(cost, 1)
        c_new = jnp.take_along_axis(cost, ci[:, None], 1)[:, 0]
        upd = c_new < best_cost
        best_mv = jnp.where(
            upd[:, None],
            jnp.take_along_axis(cands, ci[:, None, None], 1)[:, 0], best_mv)
        best_pred = jnp.where(
            upd[:, None, None],
            jnp.take_along_axis(pk, ci[:, None, None, None], 1)[:, 0],
            best_pred)
        best_sse = jnp.where(
            upd, jnp.take_along_axis(sse, ci[:, None], 1)[:, 0], best_sse)
        best_cost = jnp.minimum(best_cost, c_new)
    return best_mv, best_pred, best_sse, best_cost


# ---------------------------------------------------------------------------
# GT (geometric transform / HOP) prediction + search
# ---------------------------------------------------------------------------

def _gt4(gtc: jnp.ndarray) -> jnp.ndarray:
    """Coded corners [..., 3, 2] (TL, TR, BR) -> full [..., 4, 2] with the
    affine-derived BL = TL + BR - TR (IT_GT_AFFINE: only 3 corner vectors
    are coded, TypeDef.h:212; TDecSbac.cpp:1329-1345)."""
    bl = gtc[..., 0, :] + gtc[..., 2, :] - gtc[..., 1, :]
    return jnp.concatenate([gtc, bl[..., None, :]], axis=-2)


def _gt_window(plane, pos, mv_px, n, h_clip):
    """Gather the [B, 2n, 2n] GT reference window centered on pos+mv."""
    y0 = pos[:, 1] + mv_px[:, 1] - n // 2
    x0 = pos[:, 0] + mv_px[:, 0] - n // 2
    ry = y0[:, None, None] + jnp.arange(2 * n)[None, :, None]
    rx = x0[:, None, None] + jnp.arange(2 * n)[None, None, :]
    return plane[jnp.clip(ry, 0, h_clip - 1),
                 jnp.clip(rx, 0, plane.shape[1] - 1)]


def gt_pred_luma(plane, pos, mv_px, gtc, n, h_clip, bit_depth):
    """Decoder-grade GT luma prediction (shared by encoder tournament)."""
    from hevc_hop_tpu.ops import warp as warpop
    win = _gt_window(plane, pos, mv_px, n, h_clip)
    pred, _ = warpop.warp_blocks(win, _gt4(gtc), n, bit_depth)
    return pred


def gt_pred_chroma(plane, cpos, mv_px, gtc, m, h_clip, bit_depth):
    """GT chroma, HM-exact (xPredInterChromaBlk GT path + xPredGTChroma,
    TComPrediction.cpp:1235-1420): the 2m x 2m chroma window is first
    DCTIF-interpolated at the translational MV's chroma phase (0 or 4
    eighth-pel per axis for full-pel luma MVs), then warped with Double
    corner offsets = coded GT vectors / 2."""
    from hevc_hop_tpu.ops import warp as warpop
    cf = jnp.asarray(interp.CHROMA_FILTER)
    mvc = mv_px >> 1
    phase = (mv_px & 1) * 4
    wh = cf[phase[:, 0]]
    wv = cf[phase[:, 1]]
    t = 4
    y0 = cpos[:, 1] + mvc[:, 1] - m // 2 - (t // 2 - 1)
    x0 = cpos[:, 0] + mvc[:, 0] - m // 2 - (t // 2 - 1)
    wlen = 2 * m + t - 1
    ry = y0[:, None, None] + jnp.arange(wlen)[None, :, None]
    rx = x0[:, None, None] + jnp.arange(wlen)[None, None, :]
    win = plane[jnp.clip(ry, 0, h_clip - 1),
                jnp.clip(rx, 0, plane.shape[1] - 1)]
    fwin = interp.filter_2d(win, wh, wv, 2 * m, bit_depth)
    # coded corner vectors / 2 = chroma corner offsets in half-pel units
    pred, _ = warpop.warp_blocks(fwin, _gt4(gtc), m, bit_depth, half=True)
    return pred


def gt_chroma_safe(plane, cpos, mv_px, gtc, m, h_clip, bit_depth):
    """Safety mask of the chroma GT warp (same window/filter pipeline as
    gt_pred_chroma): False where the reference's float64 path could round
    differently. Checked by the encoder before setting gt_flag."""
    from hevc_hop_tpu.ops import warp as warpop
    cf = jnp.asarray(interp.CHROMA_FILTER)
    mvc = mv_px >> 1
    phase = (mv_px & 1) * 4
    wh = cf[phase[:, 0]]
    wv = cf[phase[:, 1]]
    t = 4
    y0 = cpos[:, 1] + mvc[:, 1] - m // 2 - (t // 2 - 1)
    x0 = cpos[:, 0] + mvc[:, 0] - m // 2 - (t // 2 - 1)
    wlen = 2 * m + t - 1
    ry = y0[:, None, None] + jnp.arange(wlen)[None, :, None]
    rx = x0[:, None, None] + jnp.arange(wlen)[None, None, :]
    win = plane[jnp.clip(ry, 0, h_clip - 1),
                jnp.clip(rx, 0, plane.shape[1] - 1)]
    fwin = interp.filter_2d(win, wh, wv, 2 * m, bit_depth)
    _, safe = warpop.warp_blocks(fwin, _gt4(gtc), m, bit_depth, half=True)
    return safe


def _gt_bits(gtc: jnp.ndarray) -> jnp.ndarray:
    """EXACT bin count of code_gt's 3 coded corner vectors: per component
    greater0 + greater1 + EG1(|v|-2) + sign — the same binarization as
    codeMvd (TEncSbac.cpp:1051 codeGT / native cabac.cpp code_gt), so the
    tournament charges what the serializer will write (getBitsGT analog,
    TComRdCost.h:205-213)."""
    return jnp.sum(_mvd_bits(gtc), axis=(-2, -1))


def _gt_search(recon, org, pos, mv, n, lam, h, bit_depth, iters: int = 6):
    """Hierarchical diamond corner search (TEncSearch.cpp:4686/5093
    xPatternSearchGT, diamond IT_GT_SEARCH=2, window-halving NSS) around a
    causally-valid anchor MV.

    Batched: each iteration evaluates moving any one coded corner by +-s on
    either axis (12 candidates) + keep (1), all as one warp batch.
    Returns (gtc [B,3,2] int32, pred [B,n,n], cost [B])."""
    from hevc_hop_tpu.ops import warp as warpop
    b = pos.shape[0]
    win = _gt_window(recon, pos, mv, n, h)
    of = org.astype(jnp.float32)

    # candidate displacement table (static): keep + 3 corners x 4 dirs
    dirs = np.array([(1, 0), (-1, 0), (0, 1), (0, -1)], np.int32)
    moves = np.zeros((13, 3, 2), np.int32)
    for c in range(3):
        for d in range(4):
            moves[1 + c * 4 + d, c] = dirs[d]
    moves_j = jnp.asarray(moves)

    def eval_cands(gtk):
        """gtk: [B, K, 3, 2] -> (sse+rate [B, K], preds [B, K, n, n]).
        Luma knife-edge candidates (warp safety mask False) cost +inf so
        the search converges onto reference-decoder-exact corner sets;
        the scan step's final gate re-checks chroma (gt_chroma_safe)."""
        k = gtk.shape[1]
        c4 = _gt4(gtk).reshape(b * k, 4, 2)
        winb = jnp.broadcast_to(win[:, None], (b, k, 2 * n, 2 * n))
        preds, safe = warpop.warp_blocks(
            winb.reshape(b * k, 2 * n, 2 * n), c4, n, bit_depth)
        preds = preds.reshape(b, k, n, n)
        safe = safe.reshape(b, k)
        sse = jnp.sum((of[:, None] - preds.astype(jnp.float32)) ** 2,
                      axis=(2, 3))
        return jnp.where(safe, sse + lam * _gt_bits(gtk), jnp.float32(1e30)
                         ), preds

    gtc = jnp.zeros((b, 3, 2), jnp.int32)
    cost0, pred0 = eval_cands(gtc[:, None])
    best_cost = cost0[:, 0]
    best_pred = pred0[:, 0]
    s = n // 2
    for _ in range(iters):
        cands = gtc[:, None] + moves_j[None] * s
        costs, preds = eval_cands(cands)
        ki = jnp.argmin(costs, axis=1)
        c_new = jnp.take_along_axis(costs, ki[:, None], 1)[:, 0]
        upd = c_new < best_cost
        gtc = jnp.where(upd[:, None, None],
                        jnp.take_along_axis(
                            cands, ki[:, None, None, None], 1)[:, 0], gtc)
        best_pred = jnp.where(
            upd[:, None, None],
            jnp.take_along_axis(preds, ki[:, None, None, None], 1)[:, 0],
            best_pred)
        best_cost = jnp.minimum(best_cost, c_new)
        s = max(1, s // 2)
    return gtc, best_pred, best_cost



def _gt_arm(ry, org, pos, zcur, zmax2n_l, anchors, gt_rate, gt_ok, p_ss,
            n, lam, w, h, bit_depth):
    """Multi-anchor GT refinement (the anchor ring of xPatternSearchGT,
    TEncSearch.cpp:5093-5141): corner-search every causally-valid anchor —
    the K best SS displacements plus the best AMVP predictor — and keep
    the RD-best result. Returns (gcost [B] incl corner+MVD+flag rate,
    gtc [B,3,2], gpred [B,n,n], amv [B,2] full-pel, ok_any [B])."""
    b = pos.shape[0]
    pr = p_ss[:, 0]
    valid_p = jnp.all(jnp.abs(pr) < _HUGE_PRED // 2, axis=-1)
    prd = jnp.where(valid_p[:, None], (pr + 2) >> 2, 0)
    ok_p = ss_anchor_ok(pos, zcur, zmax2n_l, prd, n, w, h) & valid_p
    rate_p = lam * (INTER_BITS
                    + _min_rate_bits((prd * 4)[:, None], p_ss)[:, 0])
    # drop the predictor anchor when it duplicates an SS anchor
    dup = jnp.any(jnp.all(anchors == prd[:, None], axis=-1) & gt_ok, axis=1)
    ok_p = ok_p & ~dup
    anchors = jnp.concatenate([anchors, prd[:, None]], 1)    # [B, A, 2]
    gt_rate = jnp.concatenate([gt_rate, rate_p[:, None]], 1)
    gt_ok = jnp.concatenate([gt_ok, ok_p[:, None]], 1)
    a = anchors.shape[1]
    pos_r = jnp.repeat(pos, a, 0)
    org_r = jnp.repeat(org, a, 0)
    gtc_a, gpred_a, gcost_a = _gt_search(
        ry, org_r, pos_r, anchors.reshape(-1, 2), n, lam, h, bit_depth)
    gcost_a = gcost_a.reshape(b, a) + gt_rate + lam   # + gt_flag bin
    gcost_a = jnp.where(gt_ok, gcost_a, jnp.float32(3e38))
    ai = jnp.argmin(gcost_a, 1)
    gcost = jnp.take_along_axis(gcost_a, ai[:, None], 1)[:, 0]
    amv = jnp.take_along_axis(anchors, ai[:, None, None], 1)[:, 0]
    gtc = jnp.take_along_axis(gtc_a.reshape(b, a, 3, 2),
                              ai[:, None, None, None], 1)[:, 0]
    gpred = jnp.take_along_axis(gpred_a.reshape(b, a, n, n),
                                ai[:, None, None, None], 1)[:, 0]
    return gcost, gtc, gpred, amv, jnp.any(gt_ok, 1)


def _tqr(org, pred, n, qp, bit_depth, rdoq_cfg=None, scan_id=None,
         c_idx=0, sbh=False):
    """Transform/quant/dequant/inv-transform/recon for one batch.

    rdoq_cfg: None for the plain dead-zone quantizer, or (init_type, lam)
    for RDOQ level decisions (ops/rdoq.py); scan_id [B] selects the MDCS
    scan (intra 4x4/8x8 only; inter blocks pass diag); sbh applies the
    sign-bit-hiding parity fix (quant.sbh_adjust) before recon so the
    reconstruction uses the exact levels the serializer will code."""
    log2 = n.bit_length() - 1
    resi = org - pred
    use_dst = False  # DST only for 4x4 intra luma; ISS CUs are >= 8
    coef = transform.fwd_transform(resi, bit_depth, use_dst)
    if scan_id is None:
        scan_id = jnp.zeros(org.shape[:1], jnp.int32)
    if rdoq_cfg is None:
        lev = quant.quant(coef, qp, log2, bit_depth, True)
    else:
        init_type, lam = rdoq_cfg
        lev = rdoq.rdoq_quant(coef, scan_id, qp=qp, log2_size=log2,
                              bit_depth=bit_depth, c_idx=c_idx,
                              init_type=init_type, lam=lam)
    if sbh:
        lev = quant.sbh_adjust(lev, scan_id, c_idx, coef, qp, bit_depth,
                               lam=rdoq_cfg[1] if rdoq_cfg else 0.0)
    deq = quant.dequant(lev, qp, log2, bit_depth)
    rq = transform.inv_transform(deq, bit_depth, use_dst)
    rec = jnp.clip(pred + rq, 0, (1 << bit_depth) - 1)
    cbf = jnp.any(lev != 0, axis=(1, 2))
    return lev, rec, cbf


@functools.partial(jax.jit, static_argnames=(
    "sizes", "qp", "qp_c", "bit_depth", "strong", "w", "h", "radius",
    "mi_size", "gt", "use_rdoq", "sbh", "fixed_mode"))
def scan_encode_iss(org_y, org_cb, org_cr, xs, zmaxw, zmax2n,
                    sizes: tuple, qp: int, qp_c: int, bit_depth: int,
                    strong: bool, w: int, h: int, radius: int,
                    mi_size: int = 0, gt: bool = False,
                    use_rdoq: bool = False, sbh: bool = False,
                    fixed_mode: bool = False):
    """ISS whole-frame encode as one scan.

    xs: {log2: (pos [S,B,2], avail, availc, zcur [S,B], nbav [S,B,5],
    miav [S,B,3])}; zmaxw/zmax2n: {log2: static causality planes}.
    The tournament per block: 35-mode intra, AMVP SS (integer full search
    + half/quarter-pel DIF refinement), merge candidates (exact qpel MC,
    causal veto), GT warp. MVD/merge rates are dynamic, predictor-relative
    (carried motion planes). Returns recon + coef planes and outs[log2] =
    (inter, mv_qpel, intra_mode, cbf y/cb/cr, gtflag, gtc [S,B,3,2]).
    """
    ry = jnp.zeros_like(org_y)
    rcb = jnp.zeros_like(org_cb)
    rcr = jnp.zeros_like(org_cr)
    cy_ = jnp.zeros_like(org_y)
    ccb = jnp.zeros_like(org_cb)
    ccr = jnp.zeros_like(org_cr)
    mvx4 = jnp.zeros((org_y.shape[0] // 4, w // 4), jnp.int32)
    mvy4 = jnp.zeros_like(mvx4)
    pi4 = jnp.zeros_like(mvx4)
    rf4 = jnp.zeros_like(mvx4)
    lam = partition.full_lambda(qp)
    lam_i = lam * INTRA_BITS
    rcfg_y = (3, lam) if use_rdoq else None           # init_type ISS
    rcfg_c = (3, lam * 2.0 ** ((qp_c - qp) / 3.0)) if use_rdoq else None

    def step(carry, x):
        ry, rcb, rcr, cy_, ccb, ccr, mvx4, mvy4, pi4, rf4 = carry
        outs = {}
        for log2 in sizes:
            n = 1 << log2
            m = n // 2
            if fixed_mode:
                pos, avail, availc, zcur, nbav, miav, im = x[log2]
            else:
                pos, avail, availc, zcur, nbav, miav = x[log2]
            rows, cols = _block_idx(pos, n)
            org = org_y[rows, cols]
            of = org.astype(jnp.float32)

            # intra candidate: pre-pass RD-chosen mode when available
            # (single-mode predict), else in-loop 35-mode SATD RMD
            chains = intra.substitute_refs(_gather_chains(ry, pos, n),
                                           avail, bit_depth)
            if fixed_mode:
                imode = im
                ipred = intra.predict_mode(chains, imode, n, 0, bit_depth,
                                           strong)
            else:
                preds = intra.predict_all_modes(chains, n, 0, bit_depth,
                                                strong)
                scosts = intra.satd(org[:, None], preds)
                imode = jnp.argmin(scosts, axis=1).astype(jnp.int32)
                ipred = jnp.take_along_axis(
                    preds, imode[:, None, None, None], axis=1)[:, 0]
            icost = jnp.sum((org - ipred).astype(jnp.float32) ** 2,
                            axis=(1, 2)) + lam_i

            # merge/AMVP raw material from the carried motion field
            cands, cref, cvalid, p_ss, _ = _gather_cands(
                mvx4, mvy4, pi4, rf4, pos, nbav, miav, n, mi_size, 0)
            rate_map = _dyn_rate_map(p_ss, radius, lam)

            # SS candidate (+ GT anchor ring: K best fully-causal MVs)
            mv_i, _, sspred0, sssse0, anchors, gtrate, gtok = _ss_search(
                ry, org, pos, zcur, zmaxw[log2], rate_map,
                n, radius, w, h, zmax2n[log2] if gt else None)
            mvq, sspred, _, sscost = _frac_refine(
                ry, of, pos, mv_i * 4, sspred0, sssse0, p_ss, n, h,
                bit_depth, lam)

            # merge arms (exact qpel MC at neighbor/MI/zero MVs)
            mcost, mmv, _, mpred = _merge_arms(
                ry, None, of, pos, zcur, zmaxw[log2], cands, cref, cvalid,
                0, n, w, h, bit_depth, lam)

            # GT refinement over the anchor ring (SS best-K + predictor)
            if gt:
                gcost, gtc, gpred, amv, gok = _gt_arm(
                    ry, org, pos, zcur, zmax2n[log2], anchors, gtrate,
                    gtok, p_ss, n, lam, w, h, bit_depth)
                nonzero = jnp.any(gtc != 0, axis=(1, 2))
                cpos_g = pos // 2
                cpos_g = cpos_g.at[:, 1].set(
                    jnp.where(pos[:, 1] >= h, h // 2, cpos_g[:, 1]))
                csafe = (gt_chroma_safe(rcb, cpos_g, amv, gtc, n // 2,
                                        h // 2, bit_depth)
                         & gt_chroma_safe(rcr, cpos_g, amv, gtc, n // 2,
                                          h // 2, bit_depth))
                gtflag = (gok & nonzero & csafe & (gcost < sscost)
                          & (gcost < icost) & (gcost < mcost))
            else:
                gtc = jnp.zeros(pos.shape[:1] + (3, 2), jnp.int32)
                gpred = sspred
                amv = jnp.zeros(pos.shape[:1] + (2,), jnp.int32)
                gtflag = jnp.zeros(pos.shape[:1], bool)

            merge_win = (~gtflag) & (mcost < sscost) & (mcost < icost)
            inter = gtflag | merge_win | (sscost < icost)
            mv = jnp.where(gtflag[:, None], amv * 4,
                           jnp.where(merge_win[:, None], mmv, mvq))
            pred = jnp.where(
                gtflag[:, None, None], gpred,
                jnp.where(merge_win[:, None, None], mpred,
                          jnp.where(inter[:, None, None], sspred, ipred)))
            lev, rec, cbf = _tqr(org, pred, n, qp, bit_depth, rcfg_y,
                                 _mdcs_intra(inter, imode, n), 0, sbh)
            ry = ry.at[rows, cols].set(rec)
            cy_ = cy_.at[rows, cols].set(lev)

            # carried motion planes (4x4 granularity) for later blocks'
            # merge/AMVP derivation
            r4, c4 = _block_idx(pos // 4, n // 4)
            u = (n // 4, n // 4)
            bcast = lambda v: jnp.broadcast_to(v[:, None, None],
                                               (v.shape[0],) + u)
            mvx4 = mvx4.at[r4, c4].set(bcast(jnp.where(inter, mv[:, 0], 0)))
            mvy4 = mvy4.at[r4, c4].set(bcast(jnp.where(inter, mv[:, 1], 0)))
            pi4 = pi4.at[r4, c4].set(bcast(inter.astype(jnp.int32)))

            # chroma: DM intra vs qpel MC vs GT warp, same decision as luma
            cpos = pos // 2
            cpos = cpos.at[:, 1].set(
                jnp.where(pos[:, 1] >= h, h // 2, cpos[:, 1]))
            crows, ccols = _block_idx(cpos, m)

            def chroma_plane(rc, cc, orgp):
                orgc = orgp[crows, ccols]
                ch = intra.substitute_refs(_gather_chains(rc, cpos, m),
                                           availc, bit_depth)
                cip = intra.predict_mode(ch, imode, m, 1, bit_depth,
                                         strong)
                cmc = interp.chroma_mc_q(rc, cpos, mv, m, h // 2, bit_depth)
                cpred = jnp.where(inter[:, None, None], cmc, cip)
                if gt:
                    cgt = gt_pred_chroma(rc, cpos, mv >> 2, gtc, m, h // 2,
                                         bit_depth)
                    cpred = jnp.where(gtflag[:, None, None], cgt, cpred)
                clev, crec, ccbf = _tqr(orgc, cpred, m, qp_c, bit_depth,
                                        rcfg_c,
                                        _mdcs_intra(inter, imode, m, 1), 1,
                                        sbh)
                rc = rc.at[crows, ccols].set(crec)
                cc = cc.at[crows, ccols].set(clev)
                return rc, cc, ccbf

            rcb, ccb, cbf_b = chroma_plane(rcb, ccb, org_cb)
            rcr, ccr, cbf_r = chroma_plane(rcr, ccr, org_cr)
            outs[log2] = (inter, mv, imode, cbf, cbf_b, cbf_r, gtflag, gtc)
        return (ry, rcb, rcr, cy_, ccb, ccr, mvx4, mvy4, pi4, rf4), outs

    carry, outs = jax.lax.scan(
        step, (ry, rcb, rcr, cy_, ccb, ccr, mvx4, mvy4, pi4, rf4), xs)
    ry, rcb, rcr, cy_, ccb, ccr = carry[:6]
    return ry, rcb, rcr, cy_, ccb, ccr, outs


@functools.partial(jax.jit, static_argnames=(
    "sizes", "qp", "qp_c", "bit_depth", "strong", "w", "h", "radius",
    "radius_t", "mi_size", "gt", "use_rdoq", "sbh", "fixed_mode"))
def scan_encode_pss(org_y, org_cb, org_cr, ref_y, ref_cb, ref_cr,
                    xs, zmaxw, zmax2n,
                    sizes: tuple, qp: int, qp_c: int, bit_depth: int,
                    strong: bool, w: int, h: int, radius: int,
                    radius_t: int, mi_size: int = 0, gt: bool = False,
                    use_rdoq: bool = False, sbh: bool = False,
                    fixed_mode: bool = False):
    """PSS whole-frame encode: intra / temporal / SS / merge / GT
    tournament, qpel throughout.

    ref_*: previous picture's filtered recon (the temporal L0[0]); the SS
    reference is the recon carry, coded as the LAST L0 entry
    (TComSlice.cpp:497-506). Outputs outs[log2] = (inter, refsel [S,B]
    (0=temporal, 1=SS), mv_qpel, intra_mode, cbf y/cb/cr, gtflag, gtc).
    """
    ry = jnp.zeros_like(org_y)
    rcb = jnp.zeros_like(org_cb)
    rcr = jnp.zeros_like(org_cr)
    cy_ = jnp.zeros_like(org_y)
    ccb = jnp.zeros_like(org_cb)
    ccr = jnp.zeros_like(org_cr)
    mvx4 = jnp.zeros((org_y.shape[0] // 4, w // 4), jnp.int32)
    mvy4 = jnp.zeros_like(mvx4)
    pi4 = jnp.zeros_like(mvx4)
    rf4 = jnp.zeros_like(mvx4)
    lam = partition.full_lambda(qp)
    lam_i = lam * INTRA_BITS
    rcfg_y = (4, lam) if use_rdoq else None           # init_type PSS
    rcfg_c = (4, lam * 2.0 ** ((qp_c - qp) / 3.0)) if use_rdoq else None
    SS_REF = 1  # L0 = [temporal, SS]

    def step(carry, x):
        ry, rcb, rcr, cy_, ccb, ccr, mvx4, mvy4, pi4, rf4 = carry
        outs = {}
        for log2 in sizes:
            n = 1 << log2
            m = n // 2
            if fixed_mode:
                pos, avail, availc, zcur, nbav, miav, im = x[log2]
            else:
                pos, avail, availc, zcur, nbav, miav = x[log2]
            rows, cols = _block_idx(pos, n)
            org = org_y[rows, cols]
            of = org.astype(jnp.float32)

            chains = intra.substitute_refs(_gather_chains(ry, pos, n),
                                           avail, bit_depth)
            if fixed_mode:
                imode = im
                ipred = intra.predict_mode(chains, imode, n, 0, bit_depth,
                                           strong)
            else:
                preds = intra.predict_all_modes(chains, n, 0, bit_depth,
                                                strong)
                scosts = intra.satd(org[:, None], preds)
                imode = jnp.argmin(scosts, axis=1).astype(jnp.int32)
                ipred = jnp.take_along_axis(
                    preds, imode[:, None, None, None], axis=1)[:, 0]
            icost = jnp.sum((org - ipred).astype(jnp.float32) ** 2,
                            axis=(1, 2)) + lam_i

            cands, cref, cvalid, p_ss, p_t = _gather_cands(
                mvx4, mvy4, pi4, rf4, pos, nbav, miav, n, mi_size, SS_REF)
            srate_map = _dyn_rate_map(p_ss, radius, lam)
            trate_map = _dyn_rate_map(p_t, radius_t, lam)

            mv_si, _, sspred0, sssse0, anchors, gtrate, gtok = _ss_search(
                ry, org, pos, zcur, zmaxw[log2], srate_map,
                n, radius, w, h, zmax2n[log2] if gt else None)
            mv_sq, sspred, _, sscost = _frac_refine(
                ry, of, pos, mv_si * 4, sspred0, sssse0, p_ss, n, h,
                bit_depth, lam)
            mv_ti, _, tpred0, tsse0 = _t_search(
                ref_y, org, pos, trate_map, n, radius_t, w, h)
            mv_tq, tpred, _, tcost = _frac_refine(
                ref_y, of, pos, mv_ti * 4, tpred0, tsse0, p_t, n, h,
                bit_depth, lam)

            mcost, mmv, mref, mpred = _merge_arms(
                ry, ref_y, of, pos, zcur, zmaxw[log2], cands, cref, cvalid,
                SS_REF, n, w, h, bit_depth, lam)

            if gt:
                gcost, gtc, gpred, amv, gok = _gt_arm(
                    ry, org, pos, zcur, zmax2n[log2], anchors, gtrate,
                    gtok, p_ss, n, lam, w, h, bit_depth)
                nonzero = jnp.any(gtc != 0, axis=(1, 2))
                cpos_g = pos // 2
                cpos_g = cpos_g.at[:, 1].set(
                    jnp.where(pos[:, 1] >= h, h // 2, cpos_g[:, 1]))
                csafe = (gt_chroma_safe(rcb, cpos_g, amv, gtc, n // 2,
                                        h // 2, bit_depth)
                         & gt_chroma_safe(rcr, cpos_g, amv, gtc, n // 2,
                                          h // 2, bit_depth))
                gtflag = (gok & nonzero & csafe & (gcost < sscost)
                          & (gcost < icost) & (gcost < tcost)
                          & (gcost < mcost))
            else:
                gtc = jnp.zeros(pos.shape[:1] + (3, 2), jnp.int32)
                gpred = sspred
                amv = jnp.zeros(pos.shape[:1] + (2,), jnp.int32)
                gtflag = jnp.zeros(pos.shape[:1], bool)

            ss_beats_t = sscost < tcost
            intercost = jnp.minimum(sscost, tcost)
            merge_win = ((~gtflag) & (mcost < intercost) & (mcost < icost))
            amvp_win = (~gtflag) & (~merge_win) & (intercost < icost)
            inter = gtflag | merge_win | amvp_win
            mv = jnp.where(
                gtflag[:, None], amv * 4,
                jnp.where(merge_win[:, None], mmv,
                          jnp.where(ss_beats_t[:, None], mv_sq, mv_tq)))
            refsel = jnp.where(
                gtflag, SS_REF,
                jnp.where(merge_win, mref,
                          jnp.where(ss_beats_t, SS_REF, 0))).astype(
                              jnp.int32)
            use_ss = inter & (refsel == SS_REF)
            pred = jnp.where(
                gtflag[:, None, None], gpred,
                jnp.where(
                    merge_win[:, None, None], mpred,
                    jnp.where(amvp_win[:, None, None],
                              jnp.where(ss_beats_t[:, None, None],
                                        sspred, tpred), ipred)))
            lev, rec, cbf = _tqr(org, pred, n, qp, bit_depth, rcfg_y,
                                 _mdcs_intra(inter, imode, n), 0, sbh)
            ry = ry.at[rows, cols].set(rec)
            cy_ = cy_.at[rows, cols].set(lev)

            r4, c4 = _block_idx(pos // 4, n // 4)
            u = (n // 4, n // 4)
            bcast = lambda v: jnp.broadcast_to(v[:, None, None],
                                               (v.shape[0],) + u)
            mvx4 = mvx4.at[r4, c4].set(bcast(jnp.where(inter, mv[:, 0], 0)))
            mvy4 = mvy4.at[r4, c4].set(bcast(jnp.where(inter, mv[:, 1], 0)))
            pi4 = pi4.at[r4, c4].set(bcast(inter.astype(jnp.int32)))
            rf4 = rf4.at[r4, c4].set(bcast(jnp.where(inter, refsel, 0)))

            cpos = pos // 2
            cpos = cpos.at[:, 1].set(
                jnp.where(pos[:, 1] >= h, h // 2, cpos[:, 1]))
            crows, ccols = _block_idx(cpos, m)

            def chroma_plane(rc, cc, orgp, refc):
                orgc = orgp[crows, ccols]
                ch = intra.substitute_refs(_gather_chains(rc, cpos, m),
                                           availc, bit_depth)
                cip = intra.predict_mode(ch, imode, m, 1, bit_depth,
                                         strong)
                css = interp.chroma_mc_q(rc, cpos, mv, m, h // 2, bit_depth)
                ct = interp.chroma_mc_q(refc, cpos, mv, m, h // 2, bit_depth)
                cpred = jnp.where(
                    use_ss[:, None, None], css,
                    jnp.where(inter[:, None, None], ct, cip))
                if gt:
                    cgt = gt_pred_chroma(rc, cpos, mv >> 2, gtc, m, h // 2,
                                         bit_depth)
                    cpred = jnp.where(gtflag[:, None, None], cgt, cpred)
                clev, crec, ccbf = _tqr(orgc, cpred, m, qp_c, bit_depth,
                                        rcfg_c,
                                        _mdcs_intra(inter, imode, m, 1), 1,
                                        sbh)
                rc = rc.at[crows, ccols].set(crec)
                cc = cc.at[crows, ccols].set(clev)
                return rc, cc, ccbf

            rcb, ccb, cbf_b = chroma_plane(rcb, ccb, org_cb, ref_cb)
            rcr, ccr, cbf_r = chroma_plane(rcr, ccr, org_cr, ref_cr)
            outs[log2] = (inter, refsel, mv, imode, cbf, cbf_b, cbf_r,
                          gtflag, gtc)
        return (ry, rcb, rcr, cy_, ccb, ccr, mvx4, mvy4, pi4, rf4), outs

    carry, outs = jax.lax.scan(
        step, (ry, rcb, rcr, cy_, ccb, ccr, mvx4, mvy4, pi4, rf4), xs)
    ry, rcb, rcr, cy_, ccb, ccr = carry[:6]
    return ry, rcb, rcr, cy_, ccb, ccr, outs


@functools.partial(jax.jit, static_argnames=(
    "sizes", "bit_depth", "strong", "h"))
def scan_decode_ss(resi_y, resi_cb, resi_cr, xs, sizes: tuple,
                   bit_depth: int, strong: bool, h: int):
    """ISS/PSS-within-frame decode scan.

    xs: {log2: (pos, avail, availc, modes, cmodes, inter [S,B] int32,
    mv_qpel [S,B,2], gtflag [S,B] int32, gtv [S,B,6] int32)}. Inter luma
    runs through the full quarter-pel 8-tap path (zero-phase is exactly a
    copy), chroma through the 4-tap path; GT PUs through the warp kernels.
    """
    ry = jnp.zeros_like(resi_y)
    rcb = jnp.zeros_like(resi_cb)
    rcr = jnp.zeros_like(resi_cr)

    def step(carry, x):
        ry, rcb, rcr = carry
        for log2 in sizes:
            n = 1 << log2
            m = n // 2
            pos, avail, availc, modes, cmodes, inter, mvq, gtf, gtv = x[log2]
            gtc = gtv.reshape(gtv.shape[0], 3, 2)
            chains = intra.substitute_refs(_gather_chains(ry, pos, n),
                                           avail, bit_depth)
            ipred = intra.predict_mode(chains, modes, n, 0, bit_depth,
                                       strong)
            mcp = interp.luma_mc(ry, pos, mvq, n, h, bit_depth)
            mvpx = mvq >> 2
            gtp = gt_pred_luma(ry, pos, mvpx, gtc, n, h, bit_depth)
            pred = jnp.where(gtf[:, None, None] != 0, gtp,
                             jnp.where(inter[:, None, None] != 0,
                                       mcp, ipred))
            rows, cols = _block_idx(pos, n)
            rec = jnp.clip(pred + resi_y[rows, cols],
                           0, (1 << bit_depth) - 1)
            ry = ry.at[rows, cols].set(rec)

            cpos = pos // 2
            cpos = cpos.at[:, 1].set(
                jnp.where(pos[:, 1] >= h, h // 2, cpos[:, 1]))
            crows, ccols = _block_idx(cpos, m)

            def chroma_plane(rc, resip):
                ch = intra.substitute_refs(_gather_chains(rc, cpos, m),
                                           availc, bit_depth)
                cip = intra.predict_mode(ch, cmodes, m, 1, bit_depth, strong)
                cmc = interp.chroma_mc_q(rc, cpos, mvq, m, h // 2, bit_depth)
                cgt = gt_pred_chroma(rc, cpos, mvpx, gtc, m, h // 2,
                                     bit_depth)
                cpred = jnp.where(gtf[:, None, None] != 0, cgt,
                                  jnp.where(inter[:, None, None] != 0,
                                            cmc, cip))
                crec = jnp.clip(cpred + resip[crows, ccols],
                                0, (1 << bit_depth) - 1)
                return rc.at[crows, ccols].set(crec)

            rcb = chroma_plane(rcb, resi_cb)
            rcr = chroma_plane(rcr, resi_cr)
        return (ry, rcb, rcr), None

    (ry, rcb, rcr), _ = jax.lax.scan(step, (ry, rcb, rcr), xs)
    return ry, rcb, rcr


@functools.partial(jax.jit, static_argnames=(
    "sizes", "bit_depth", "strong", "h"))
def scan_decode_pss(resi_y, resi_cb, resi_cr, ref_y, ref_cb, ref_cr,
                    xs, sizes: tuple, bit_depth: int, strong: bool, h: int):
    """PSS decode scan: temporal PUs read the static reference picture
    (no scheduling dependency); SS/GT PUs read the recon carry.

    xs: {log2: (pos, avail, availc, modes, cmodes, ssf [S,B], tf [S,B],
    mv_qpel, gtflag, gtv)}."""
    ry = jnp.zeros_like(resi_y)
    rcb = jnp.zeros_like(resi_cb)
    rcr = jnp.zeros_like(resi_cr)

    def step(carry, x):
        ry, rcb, rcr = carry
        for log2 in sizes:
            n = 1 << log2
            m = n // 2
            (pos, avail, availc, modes, cmodes, ssf, tf, mvq,
             gtf, gtv) = x[log2]
            gtc = gtv.reshape(gtv.shape[0], 3, 2)
            chains = intra.substitute_refs(_gather_chains(ry, pos, n),
                                           avail, bit_depth)
            ipred = intra.predict_mode(chains, modes, n, 0, bit_depth,
                                       strong)
            ssp = interp.luma_mc(ry, pos, mvq, n, h, bit_depth)
            tp = interp.luma_mc(ref_y, pos, mvq, n, h, bit_depth)
            mvpx = mvq >> 2
            gtp = gt_pred_luma(ry, pos, mvpx, gtc, n, h, bit_depth)
            pred = jnp.where(
                gtf[:, None, None] != 0, gtp,
                jnp.where(ssf[:, None, None] != 0, ssp,
                          jnp.where(tf[:, None, None] != 0, tp, ipred)))
            rows, cols = _block_idx(pos, n)
            rec = jnp.clip(pred + resi_y[rows, cols],
                           0, (1 << bit_depth) - 1)
            ry = ry.at[rows, cols].set(rec)

            cpos = pos // 2
            cpos = cpos.at[:, 1].set(
                jnp.where(pos[:, 1] >= h, h // 2, cpos[:, 1]))
            crows, ccols = _block_idx(cpos, m)

            def chroma_plane(rc, refc, resip):
                ch = intra.substitute_refs(_gather_chains(rc, cpos, m),
                                           availc, bit_depth)
                cip = intra.predict_mode(ch, cmodes, m, 1, bit_depth, strong)
                css = interp.chroma_mc_q(rc, cpos, mvq, m, h // 2, bit_depth)
                ct = interp.chroma_mc_q(refc, cpos, mvq, m, h // 2,
                                        bit_depth)
                cgt = gt_pred_chroma(rc, cpos, mvpx, gtc, m, h // 2,
                                     bit_depth)
                cpred = jnp.where(
                    gtf[:, None, None] != 0, cgt,
                    jnp.where(ssf[:, None, None] != 0, css,
                              jnp.where(tf[:, None, None] != 0, ct, cip)))
                crec = jnp.clip(cpred + resip[crows, ccols],
                                0, (1 << bit_depth) - 1)
                return rc.at[crows, ccols].set(crec)

            rcb = chroma_plane(rcb, ref_cb, resi_cb)
            rcr = chroma_plane(rcr, ref_cr, resi_cr)
        return (ry, rcb, rcr), None

    (ry, rcb, rcr), _ = jax.lax.scan(step, (ry, rcb, rcr), xs)
    return ry, rcb, rcr
