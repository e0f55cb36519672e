"""Rate-distortion optimized quantization (RDOQ), vectorized over TU batches.

Capability ref: TComTrQuant::xRateDistOptQuant (TComTrQuant.cpp:1489),
xGetCodedLevel (:260h), xGetICRate, last-position estimation and the
coefficient-group zeroing pass; rate estimates use the FAST_BIT_EST
fractional-bit table (ContextModel.cpp:106 m_entropyBits) with the slice's
*initial* context states.

Batched restructuring (not a port): the reference walks coefficients
sequentially in reverse scan order, evolving (c1, c1Idx, c2Idx, rice)
greedily from each *chosen* level. Here a whole batch of TUs is processed
at once: the context trajectories are derived from the pre-decision
(round-half) levels with reversed cumulative sums + one unrolled 16-step
pass per coefficient group, after which every level decision, the CG-zero
pass and the last-position/cbf tournament are closed-form tensor reductions
(prefix sums over scan order). Level choices feed the reconstruction loop,
so decisions are encoder-only and conformance-neutral; only BD-rate
changes.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from hevc_hop_tpu.common import rom
from hevc_hop_tpu.entropy import ctx_layout, tables
from hevc_hop_tpu.ops import quant

SCALE = 32768.0  # rate unit: 2^15 per bit (SCALE_BITS)
_INF = np.float32(1e30)

# kCtxMap4x4 / group-index tables (H.265 9.3.4.2.5 / TComTrQuant)
_CTX_MAP_4X4 = np.array([0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8],
                        np.int32)
_MIN_IN_GROUP = np.array([0, 1, 2, 3, 4, 6, 8, 12, 16, 24], np.int32)


def _group_idx(pos: int) -> int:
    if pos < 4:
        return pos
    k = pos.bit_length() - 1
    return 2 * k + (1 if pos >= (1 << k) + (1 << (k - 1)) else 0)


# The reference estimates rates from the CURRENT adaptive context states
# (they converge to the content statistics within a few TUs); our batched
# coding has only static costs available. Slice-init states mis-price
# several residual contexts badly (e.g. a 3.9-bit significant flag, or a
# 1-bit sig0 that really costs ~0.2 after adaptation), so the model prefers
# EMPIRICAL per-context costs measured from realized CABAC statistics
# (entropy/cal_bits.py, generated by tools/calibrate_rdoq.py), falling back
# to init-state costs for unobserved contexts.
try:
    from hevc_hop_tpu.entropy import cal_bits as _cal
except ImportError:          # calibration table not generated yet
    _cal = None
# debug stage toggles (tests/calibration only)
_STAGE_COEF = True
_STAGE_CG = True
_STAGE_LAST = True


def _ebits(states: np.ndarray, binv) -> np.ndarray:
    """Fractional bits (2^15 units) of coding bin value(s) in state(s)."""
    return tables.ENTROPY_BITS[np.asarray(states, np.int32) ^ binv]


def _ctx_bits(st: np.ndarray, base: int, cnt: int, init_type: int,
              qp: int) -> np.ndarray:
    """[cnt, 2] fractional-bit costs for a context group: calibrated
    empirical costs where measured, init-state costs otherwise."""
    states = st[base:base + cnt]
    out = np.stack([_ebits(states, 0), _ebits(states, 1)], 1)
    cal = _cal.bits_for(init_type, qp) if _cal is not None else None
    if cal is not None:
        c = cal[base:base + cnt]
        out = np.where(c >= 0, c, out)
    return out.astype(np.float32)


def _sig_ctx_table(log2: int, c_idx: int, scan: int) -> np.ndarray:
    """[4 patterns, M] sig ctx index per scan position (9.3.4.2.5)."""
    n = 1 << log2
    pos = rom.scan_order(log2, scan)
    xc, yc = pos[:, 0], pos[:, 1]
    if log2 == 2:
        t = _CTX_MAP_4X4[(yc << 2) + xc]
        return np.broadcast_to(t, (4, 16)).copy()
    out = np.zeros((4, n * n), np.int32)
    xp, yp = xc & 3, yc & 3
    for prev in range(4):
        if prev == 0:
            s = np.where(xp + yp == 0, 2, np.where(xp + yp < 3, 1, 0))
        elif prev == 1:
            s = np.where(yp == 0, 2, np.where(yp == 1, 1, 0))
        elif prev == 2:
            s = np.where(xp == 0, 2, np.where(xp == 1, 1, 0))
        else:
            s = np.full(n * n, 2, np.int32)
        if c_idx == 0:
            s = s + np.where((xc > 3) | (yc > 3), 3, 0)
            s = s + (9 if scan == 0 else 15) if log2 == 3 else s + 21
        else:
            s = s + (9 if log2 == 3 else 12)
        s = np.where((xc == 0) & (yc == 0), 0, s)
        out[prev] = s
    return out


def _last_rate_table(log2: int, c_idx: int, scan: int, bx: np.ndarray,
                     by: np.ndarray) -> np.ndarray:
    """[M] last_sig_coeff_x/y rate (2^15 units) per scan position.

    Mirrors TComTrQuant::xGetRateLast: truncated-unary ctx prefix
    (blk-size-dependent ctx spacing) + EP suffix. bx/by: [15, 2] per-ctx
    bit costs for the x/y prefix contexts.
    """
    if c_idx == 0:
        ctx_of = [((i >> ((log2 + 1) >> 2)) + ((log2 - 2) * 3
                  + ((log2 - 1) >> 2))) for i in range(2 * log2)]
    else:
        ctx_of = [(i >> (log2 - 2)) for i in range(2 * log2)]
    gmax = _group_idx((1 << log2) - 1)  # g_uiGroupIdx[n-1]

    def axis_rate(p: int, bits: np.ndarray) -> float:
        # TEncSbac::estLastSignificantPositionBit: unary prefix of g ones,
        # terminating zero unless g is the maximal group, then EP suffix
        g = _group_idx(p)
        r = 0.0
        for i in range(g):
            r += float(bits[ctx_of[i], 1])
        if g < gmax:
            r += float(bits[ctx_of[g], 0])
        if g > 3:  # EP suffix bits
            r += ((g - 2) >> 1) * SCALE
        return r

    pos = rom.scan_order(log2, scan)
    xs, ys = pos[:, 0], pos[:, 1]
    if scan == 2:  # vertical scan swaps coordinates (xGetRateLast call site)
        xs, ys = ys, xs
    rx = np.array([axis_rate(int(p), bx) for p in range(1 << log2)])
    ry = np.array([axis_rate(int(p), by) for p in range(1 << log2)])
    return (rx[xs] + ry[ys]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tables_for(log2: int, c_idx: int, qp: int, init_type: int):
    """Static per-TU-class tables: scan perms, ctx tables, init-state rates."""
    st = ctx_layout.init_states(init_type, qp)
    n = 1 << log2
    m = n * n
    off = ctx_layout.OFFSETS
    cb = functools.partial(_ctx_bits, st, init_type=init_type, qp=qp)
    lastx_bits = cb(off["LAST_X_LUMA" if c_idx == 0 else "LAST_X_CHROMA"], 15)
    lasty_bits = cb(off["LAST_Y_LUMA" if c_idx == 0 else "LAST_Y_CHROMA"], 15)
    scans = (0, 1, 2) if log2 <= 3 else (0, 0, 0)
    perm = np.stack([rom.scan_raster_index(log2, s) for s in scans])
    sig_tab = np.stack([_sig_ctx_table(log2, c_idx, s) for s in scans])
    last_tab = np.stack([_last_rate_table(log2, c_idx, s, lastx_bits,
                                          lasty_bits) for s in scans])
    # CG scan: with CG-major scans, CG scan index = pos>>4; raster CG of the
    # first coefficient of each CG gives the CG grid position.
    ncg = max(m // 16, 1)
    side = max(n // 4, 1)
    cgpos = np.zeros((3, ncg, 2), np.int32)
    for si, s in enumerate(scans):
        r = perm[si][::16]
        cgpos[si, :, 0] = (r & (n - 1)) // 4
        cgpos[si, :, 1] = (r >> log2) // 4
    sig_bits = cb(off["SIG_LUMA" if c_idx == 0 else "SIG_CHROMA"],
                  27 if c_idx == 0 else 15)
    one_bits = cb(off["ONE_LUMA" if c_idx == 0 else "ONE_CHROMA"],
                  16 if c_idx == 0 else 8)
    abs_bits = cb(off["ABS_LUMA" if c_idx == 0 else "ABS_CHROMA"],
                  4 if c_idx == 0 else 2)
    cg_bits = cb(off["SIG_CG_LUMA" if c_idx == 0 else "SIG_CG_CHROMA"], 2)
    # cbf ctx: luma trDepth==0 -> ctx 1; chroma trDepth (0) -> ctx 0
    cbf_bits = cb(off["QT_CBF_LUMA" if c_idx == 0 else "QT_CBF_CHROMA"]
                  + (1 if c_idx == 0 else 0), 1)[0]
    return dict(perm=perm, sig_tab=sig_tab, last_tab=last_tab, cgpos=cgpos,
                side=side, ncg=ncg, sig_bits=sig_bits, one_bits=one_bits,
                abs_bits=abs_bits, cg_bits=cg_bits, cbf_bits=cbf_bits)


def _level_rate(lev, one_ctx_bits0, one_ctx_bits1, abs_ctx_bits0,
                abs_ctx_bits1, rice, c1idx, c2idx):
    """xGetICRate: rate (2^15 units, float32) of coding abs level `lev`
    (incl. the EP sign bit). lev==0 -> 0."""
    base = jnp.where(c1idx < 8, 2 + (c2idx < 1).astype(jnp.int32), 1)
    sym = jnp.maximum(lev - base, 0)
    thr = 3 << rice
    # short Rice codeword
    r_short = ((sym >> rice) + 1 + rice).astype(jnp.float32) * SCALE
    # escape: len = floor(log2(cn + 2^rice)); bits = (3+len+1-rice) + len
    cn = jnp.maximum(sym - thr, 0) + (1 << rice)
    ln = quant.floor_log2(jnp.maximum(cn, 1))
    r_esc = (3 + ln + 1 - rice + ln).astype(jnp.float32) * SCALE
    r_rem = jnp.where(sym < thr, r_short, r_esc)
    rate = jnp.full(lev.shape, SCALE, jnp.float32)  # sign bit
    ge_base = lev >= base
    rate = rate + jnp.where(ge_base, r_rem, 0.0)
    rate = rate + jnp.where(ge_base & (c1idx < 8), one_ctx_bits1, 0.0)
    rate = rate + jnp.where(ge_base & (c1idx < 8) & (c2idx < 1),
                            abs_ctx_bits1, 0.0)
    rate = rate + jnp.where(~ge_base & (lev == 1), one_ctx_bits0, 0.0)
    rate = rate + jnp.where(~ge_base & (lev == 2),
                            one_ctx_bits1 + abs_ctx_bits0, 0.0)
    return jnp.where(lev > 0, rate, 0.0)


def rdoq_quant(coef: jnp.ndarray, scan_id: jnp.ndarray, *, qp: int,
               log2_size: int, bit_depth: int, c_idx: int, init_type: int,
               lam: float) -> jnp.ndarray:
    """RDOQ levels for a batch of TUs.

    coef: [B, N, N] int32 signed transform coefficients.
    scan_id: [B] int32 MDCS scan (0 diag, 1 hor, 2 ver; only 4x4/8x8 use 1/2).
    lam: full lambda (already chroma-weighted by the caller for chroma).
    Returns [B, N, N] int32 signed levels (same recon semantics as quant()).
    """
    t = _tables_for(log2_size, c_idx, qp, init_type)
    n = 1 << log2_size
    m = n * n
    ncg, side = t["ncg"], t["side"]
    b = coef.shape[0]
    qpe = qp + 6 * (bit_depth - 8)   # QpBdOffset (quant domain only;
    #                                  context tables stay on slice qp)
    per, rem = qpe // 6, qpe % 6
    tr_shift = rom.MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    qbits = rom.QUANT_SHIFT + per + tr_shift
    qscale = int(rom.QUANT_SCALES[rem])
    err_scale = np.float32(SCALE * (2.0 ** (-2.0 * tr_shift))
                           / (qscale * qscale)
                           / (1 << (2 * (bit_depth - 8))))
    lam = np.float32(lam)

    # MDCS applies only to 4x4 TUs and 8x8 luma (H.265 8.4.4.2.7); every
    # other TU class has a single (diagonal) scan, so its permutations and
    # context tables are compile-time constants — no per-block gathers.
    single_scan = not (log2_size == 2 or (log2_size == 3 and c_idx == 0))
    flat = coef.reshape(b, m)
    if single_scan:
        perm0 = t["perm"][0]
        c = flat[:, perm0]                               # static gather
    else:
        perm = jnp.asarray(t["perm"])[scan_id]           # [B, M]
        c = jnp.take_along_axis(flat, perm, axis=1)      # scan order
    sign = c < 0
    ld = jnp.abs(c) * qscale                             # lLevelDouble
    max_abs = (ld + (1 << (qbits - 1))) >> qbits

    pidx = jnp.arange(m, dtype=jnp.int32)
    nzp = max_abs > 0
    last_pos = jnp.max(jnp.where(nzp, pidx[None], -1), axis=1)  # [B]
    active = pidx[None] <= last_pos[:, None]

    # ---- CG sig flags (pre-decision) + neighbor pattern + sig ctx --------
    g = max_abs.reshape(b, ncg, 16)
    ga = active.reshape(b, ncg, 16)
    cg_nz = jnp.any((g > 0) & ga, axis=2)                # [B, ncg]
    if single_scan:
        cgx = jnp.asarray(t["cgpos"][0, :, 0])[None]     # [1, ncg] static
        cgy = jnp.asarray(t["cgpos"][0, :, 1])[None]
    else:
        cgx = jnp.asarray(t["cgpos"])[scan_id][..., 0]   # [B, ncg]
        cgy = jnp.asarray(t["cgpos"])[scan_id][..., 1]
    flagmap = jnp.zeros((b, side, side), bool)
    bi = jnp.arange(b, dtype=jnp.int32)[:, None]
    flagmap = flagmap.at[bi, jnp.broadcast_to(cgy, (b, ncg)),
                         jnp.broadcast_to(cgx, (b, ncg))].set(cg_nz)
    right = jnp.where(cgx + 1 < side,
                      flagmap[bi, cgy, jnp.minimum(cgx + 1, side - 1)], False)
    below = jnp.where(cgy + 1 < side,
                      flagmap[bi, jnp.minimum(cgy + 1, side - 1), cgx], False)
    pattern = right.astype(jnp.int32) + 2 * below.astype(jnp.int32)
    pattern_p = jnp.repeat(pattern, 16, axis=1)          # [B, M]
    sbits = np.asarray(t["sig_bits"])
    if single_scan:
        # bake bits-per-pattern as constants; select by one-hot (no gather)
        s0t = sbits[t["sig_tab"][0], 0]                  # [4, M] np
        s1t = sbits[t["sig_tab"][0], 1]
        sel = lambda tab: sum(
            jnp.where(pattern_p == k, jnp.asarray(tab[k])[None], 0.0)
            for k in range(4))
        sig0, sig1 = sel(s0t), sel(s1t)
    else:
        sig_tab = jnp.asarray(t["sig_tab"])[scan_id]     # [B, 4, M]
        sig_ctx = jnp.take_along_axis(
            sig_tab, pattern_p[:, None, :], axis=1)[:, 0]
        sig_bits = jnp.asarray(t["sig_bits"])
        sig0 = sig_bits[sig_ctx, 0]
        sig1 = sig_bits[sig_ctx, 1]

    # ---- context trajectories from pre-decision levels -------------------
    gz = ((g > 0) & ga).astype(jnp.int32)
    g1 = ((g > 1) & ga).astype(jnp.int32)
    # counts of coded coeffs strictly after j in scan order (processed first)
    rcount = lambda a: (jnp.cumsum(a[:, :, ::-1], axis=2)[:, :, ::-1] - a)
    c1idx = rcount(gz)
    c2idx = rcount(g1)
    ones_before = c1idx - c2idx
    c1 = jnp.where(c2idx > 0, 0, jnp.minimum(3, 1 + ones_before))
    # ctx_set per CG: +2 for luma CGs after the first, +1 if previous
    # processed CG ended with c1 == 0 (any greater-1 level there)
    cg_has_g1 = jnp.any(g1 > 0, axis=2)
    cg_i = jnp.arange(ncg, dtype=jnp.int32)[None]
    prev_g1 = jnp.concatenate(
        [cg_has_g1[:, 1:], jnp.zeros((b, 1), bool)], axis=1)
    last_cg = last_pos >> 4
    bump = prev_g1 & (cg_i + 1 <= last_cg[:, None])
    ctx_set = (jnp.where((cg_i == 0) | (c_idx > 0), 0, 2)
               + bump.astype(jnp.int32))                 # [B, ncg]
    # rice param per position: closed form instead of the reference's
    # 16-step sequential walk. rice_at[j] >= i+1 iff some later-scanned
    # position k>j has lev_k >= base_k, lev_k > 3<<i AND had rice >= i at
    # entry — 4 suffix-any passes (verified equivalent to the sequential
    # update by exhaustive randomized test).
    lev_g = g * ga
    base_g = jnp.where(c1idx < 8, 2 + (c2idx < 1).astype(jnp.int32), 1)
    ge_g = lev_g >= base_g
    r_ge = jnp.ones((b, ncg, 16), bool)
    rice = jnp.zeros((b, ncg, 16), jnp.int32)
    for i in range(4):
        trig = (ge_g & (lev_g > (3 << i)) & r_ge).astype(jnp.int32)
        csum = jnp.cumsum(trig[..., ::-1], axis=-1)[..., ::-1]
        r_ge = (csum - trig) > 0
        rice = rice + r_ge.astype(jnp.int32)             # [B, ncg, 16]

    one_bits = jnp.asarray(t["one_bits"])
    abs_bits = jnp.asarray(t["abs_bits"])
    nc1 = 4 if c_idx == 0 else 4
    one_ctx = jnp.minimum(ctx_set[:, :, None] * nc1 + c1,
                          one_bits.shape[0] - 1)
    abs_ctx = jnp.minimum(ctx_set, abs_bits.shape[0] - 1)
    ob0 = one_bits[one_ctx, 0].reshape(b, m)
    ob1 = one_bits[one_ctx, 1].reshape(b, m)
    ab0 = abs_bits[abs_ctx, 0][:, :, None].repeat(16, 2).reshape(b, m)
    ab1 = abs_bits[abs_ctx, 1][:, :, None].repeat(16, 2).reshape(b, m)
    rice_f = rice.reshape(b, m)
    c1i_f = c1idx.reshape(b, m)
    c2i_f = c2idx.reshape(b, m)

    # ---- level decision (xGetCodedLevel) ---------------------------------
    is_last = pidx[None] == last_pos[:, None]
    ldf = ld.astype(jnp.float32)
    cost0 = ldf * ldf * err_scale                        # uncoded (level 0)

    def coded_cost(lev):
        err = ldf - (lev << qbits).astype(jnp.float32)
        r = _level_rate(lev, ob0, ob1, ab0, ab1, rice_f, c1i_f, c2i_f)
        return err * err * err_scale + lam * r

    cand1 = max_abs
    cand2 = jnp.maximum(max_abs - 1, 1)
    sig_cost1 = jnp.where(is_last, 0.0, lam * sig1)
    cost_c1 = coded_cost(cand1) + sig_cost1
    cost_c2 = jnp.where(max_abs > 1, coded_cost(cand2) + sig_cost1, _INF)
    # zero option: only when not last and max_abs < 3 (HM xGetCodedLevel)
    zero_ok = (~is_last) & (max_abs < 3)
    cost_z = jnp.where(zero_ok, cost0 + lam * sig0, _INF)
    lev = jnp.where(cost_c2 < cost_c1, cand2, cand1)
    cost_best = jnp.minimum(cost_c1, cost_c2)
    if not _STAGE_COEF:
        cost_z = jnp.full_like(cost_z, _INF)
    lev = jnp.where((cost_z < cost_best) | (max_abs == 0), 0, lev)
    lev = jnp.where(active, lev, 0)
    # sig-flag cost actually paid at this position (0 for last / inactive)
    cost_sig = jnp.where(is_last | ~active, 0.0,
                         jnp.where(lev > 0, lam * sig1, lam * sig0))
    cost_coeff = jnp.where(lev > 0, cost_best, cost0 + cost_sig)
    cost_coeff = jnp.where(active, cost_coeff, cost0)

    # ---- CG zeroing (explicitly coded CGs only: 0 < cg < last_cg) --------
    cg_bits = jnp.asarray(t["cg_bits"])
    cg_ctx = (right | below).astype(jnp.int32)
    cg_rate0 = lam * cg_bits[cg_ctx, 0]
    cg_rate1 = lam * cg_bits[cg_ctx, 1]
    cc = cost_coeff.reshape(b, ncg, 16)
    cz = cost0.reshape(b, ncg, 16)
    cg_final = (jnp.any(lev.reshape(b, ncg, 16) > 0, axis=2))
    zero_gain = (jnp.sum(cc, axis=2) + cg_rate1) \
        - (jnp.sum(cz, axis=2) + cg_rate0)
    can_zero = cg_final & (cg_i > 0) & (cg_i < last_cg[:, None])
    do_zero = can_zero & (zero_gain > 0) & _STAGE_CG
    zmask = jnp.repeat(do_zero, 16, axis=1)
    lev = jnp.where(zmask, 0, lev)
    cost_coeff = jnp.where(zmask, cost0, cost_coeff)
    cost_sig = jnp.where(zmask, 0.0, cost_sig)
    cg_final = cg_final & ~do_zero

    # ---- last-position / cbf tournament ----------------------------------
    # rate of CG sig flags for CGs strictly below the candidate's CG
    cg_rate = jnp.where((cg_i > 0) & (cg_i < last_cg[:, None]),
                        jnp.where(cg_final, cg_rate1, cg_rate0), 0.0)
    cg_rate_below = jnp.cumsum(cg_rate, axis=1) - cg_rate   # exclusive
    cg_rate_below_p = jnp.repeat(cg_rate_below, 16, axis=1)
    pref_coded = jnp.cumsum(cost_coeff, axis=1) - cost_coeff
    total0 = jnp.sum(cost0, axis=1, keepdims=True)
    suff_unc = total0 - jnp.cumsum(cost0, axis=1)
    if single_scan:
        last_tab = jnp.asarray(t["last_tab"][0])[None]      # [1, M] static
    else:
        last_tab = jnp.asarray(t["last_tab"])[scan_id]      # [B, M]
    cbf_bits = jnp.asarray(t["cbf_bits"])
    tot = (lam * cbf_bits[1] + lam * last_tab + cg_rate_below_p
           + pref_coded + (cost_coeff - cost_sig) + suff_unc)
    p2 = jnp.max(jnp.where(lev > 1, pidx[None], 0), axis=1)
    cand_mask = (lev > 0) & (pidx[None] >= p2[:, None])
    tot = jnp.where(cand_mask, tot, _INF)
    best_last = jnp.argmin(tot, axis=1).astype(jnp.int32)
    best_cost = jnp.take_along_axis(tot, best_last[:, None], 1)[:, 0]
    cbf0_cost = lam * cbf_bits[0] + total0[:, 0]
    keep = (best_cost < cbf0_cost) & (last_pos >= 0)
    if not _STAGE_LAST:
        keep = last_pos >= 0
        best_last = last_pos
    lev = jnp.where(keep[:, None] & (pidx[None] <= best_last[:, None]),
                    lev, 0)

    signed = jnp.where(sign, -lev, lev)
    if single_scan:
        inv = np.argsort(t["perm"][0])
        out = signed[:, inv]                       # static inverse perm
    else:
        out = jnp.zeros((b, m), jnp.int32)
        out = out.at[jnp.arange(b)[:, None], perm].set(signed)
    return out.reshape(b, n, n)
