"""Whole-frame wavefront as a single on-device lax.scan program.

The step-per-dispatch wavefront (models/wavefront.py) pays one host->device
round trip per step — thousands per frame. Here the entire schedule is baked
into static tensors and the full sequential recon loop runs as ONE compiled
XLA program: lax.scan over topological levels (computed by the native
runtime's wavefront_levels), each step processing padded per-size batches of
transform blocks (gather chains -> predict -> T/Q/IQ/IT -> recon -> scatter)
for luma and both chroma planes.

Blocks on the same topological level are mutually independent regardless of
size, so a step handles e.g. all ready 32x32, 16x16 and 8x8 TUs at once as
three static-shape sub-batches — the batched replacement for the
reference's strictly sequential CU recursion (TEncCu.cpp:371).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from hevc_hop_tpu.ops import intra, quant, rdoq, transform
from hevc_hop_tpu.models import wavefront


def _mdcs_scan_id(modes: jnp.ndarray, n: int, c_idx: int) -> jnp.ndarray:
    """Mode-dependent coefficient scan (H.265 8.4.4.2.7): 4x4 any plane and
    8x8 luma use horizontal scan for near-vertical modes, vertical for
    near-horizontal; diag otherwise."""
    if not (n == 4 or (n == 8 and c_idx == 0)):
        return jnp.zeros(modes.shape, jnp.int32)
    return jnp.where((modes >= 22) & (modes <= 30), 1,
                     jnp.where((modes >= 6) & (modes <= 14), 2, 0)
                     ).astype(jnp.int32)


def build_schedule(blocks, w: int, h: int, ctb_log2: int,
                   pad_steps: int = 64, pad_slots: int = 16,
                   force_sizes: tuple | None = None):
    """Schedule tensors for an arbitrary TU-leaf structure (z-order list).

    Returns (sizes, data) where sizes is a sorted tuple of block log2s and
    data[log2] = dict(pos [S,B,2], avail [S,B,L], availc [S,B,Lc],
    valid [S,B]) with S = number of levels (shared across sizes; dummies
    point at the (0, h) scratch row).

    The step count and per-step slot count are quantized to pad_steps /
    pad_slots buckets (and force_sizes can pin the size tuple) so that
    DIFFERENT frame partitions usually land on the SAME array shapes and
    reuse one compiled XLA program instead of recompiling per quadtree.
    """
    from hevc_hop_tpu.entropy import native as _native
    arr = np.array(blocks, np.int32)
    # NxN CUs: the 4th 4x4 PU carries the CU's 4x4 CHROMA TU, whose
    # reference chain spans the whole 8x8 CU neighborhood — wider than the
    # carrier's own luma chain, so its dependency rect is added explicitly
    rects = None
    if (arr[:, 2] == 2).any():
        rects = np.zeros((len(arr), 4), np.int32)
        car = ((arr[:, 2] == 2) & (arr[:, 0] % 8 == 4)
               & (arr[:, 1] % 8 == 4))
        rects[car] = np.stack(
            [arr[car, 0] - 6, arr[car, 1] - 6,
             np.full(car.sum(), 18), np.full(car.sum(), 18)], -1)
    levels = _native.wavefront_levels(arr[:, 0], arr[:, 1], arr[:, 2],
                                      w, h, ctb_log2, mv_rect=rects)
    nsteps = int(levels.max()) if len(levels) else 0
    if pad_steps > 1:
        nsteps = max(pad_steps, -(-nsteps // pad_steps) * pad_steps)
    zplane = wavefront.zaddr4_plane(w, h, ctb_log2)
    czplane = zplane[::2, ::2]
    sizes = (tuple(force_sizes) if force_sizes is not None
             else tuple(sorted({int(l) for l in arr[:, 2]})))
    data = {}
    for log2 in sizes:
        n = 1 << log2
        sel = arr[:, 2] == log2
        lv = levels[sel] - 1
        pts = arr[sel][:, :2]
        counts = np.bincount(lv, minlength=nsteps)
        bmax = max(1, int(counts.max()) if len(lv) else 0)
        # per-size quantum: a 32x32 slot costs 16x an 8x8 slot, so big
        # blocks use a finer bucket (same shape-reuse goal, less padding)
        slot_q = max(2, pad_slots >> max(log2 - 3, 0))
        if pad_slots > 1:
            bmax = max(slot_q, -(-bmax // slot_q) * slot_q)
        pos = np.zeros((nsteps, bmax, 2), np.int32)
        pos[:, :, 1] = h
        valid = np.zeros((nsteps, bmax), bool)
        slot = np.zeros(nsteps, np.int32)
        order = np.argsort(lv, kind="stable")
        for i in order:
            s = lv[i]
            pos[s, slot[s]] = pts[i]
            valid[s, slot[s]] = True
            slot[s] += 1
        # availability only for real slots (dummies stay all-False)
        flat = pos.reshape(-1, 2)
        vmf = valid.reshape(-1)
        fv = flat[vmf]
        avail = np.zeros((flat.shape[0], 4 * n + 1), bool)
        avail[vmf] = wavefront.avail_mask(fv, n, zplane, w, h)
        if log2 == 2:
            # chroma is a CU-level 4x4 TU carried by the 4th PU: chain of
            # the 4x4 chroma block at the CU origin (others unused)
            availc = np.zeros((flat.shape[0], 17), bool)
            availc[vmf] = wavefront.avail_mask(
                np.maximum(fv - 4, 0) // 2, 4, czplane, w // 2, h // 2)
            clen = 17
        else:
            availc = np.zeros((flat.shape[0], 2 * n + 1), bool)
            availc[vmf] = wavefront.avail_mask(fv // 2, n // 2, czplane,
                                               w // 2, h // 2)
            clen = 2 * n + 1
        data[log2] = dict(
            pos=pos, valid=valid,
            avail=avail.reshape(nsteps, bmax, 4 * n + 1),
            availc=availc.reshape(nsteps, bmax, clen))
    return sizes, data, nsteps


def _gather_chains(plane, pos, n):
    coords = jnp.asarray(
        wavefront.chain_coords(np.zeros((1, 2), np.int64), n))[0]
    cx = pos[:, 0:1] + coords[None, :, 0]
    cy = pos[:, 1:2] + coords[None, :, 1]
    return plane[jnp.clip(cy, 0, plane.shape[0] - 1),
                 jnp.clip(cx, 0, plane.shape[1] - 1)]


def _block_idx(pos, n):
    b = pos.shape[0]
    rows = pos[:, 1:2, None] + jnp.arange(n)[None, :, None]
    cols = pos[:, 0:1, None].transpose(0, 2, 1) + jnp.arange(n)[None, None, :]
    return (jnp.broadcast_to(rows, (b, n, n)),
            jnp.broadcast_to(cols, (b, n, n)))


def _enc_plane(recon, coefp, orgp, pos, avail, modes, n, qp, c_idx,
               bit_depth, strong):
    """modes: [B] int32; -1 -> in-loop SATD RMD."""
    log2 = n.bit_length() - 1
    chains = _gather_chains(recon, pos, n)
    chains = intra.substitute_refs(chains, avail, bit_depth)
    preds = intra.predict_all_modes(chains, n, c_idx, bit_depth, strong)
    rows, cols = _block_idx(pos, n)
    org = orgp[rows, cols]
    costs = intra.satd(org[:, None], preds)
    best = jnp.argmin(costs, axis=1).astype(jnp.int32)
    best = jnp.where(modes >= 0, modes, best)
    pred = jnp.take_along_axis(preds, best[:, None, None, None], axis=1)[:, 0]
    resi = org - pred
    use_dst = (n == 4 and c_idx == 0)
    coef = transform.fwd_transform(resi, bit_depth, use_dst)
    lev = quant.quant(coef, qp, log2, bit_depth, True)
    deq = quant.dequant(lev, qp, log2, bit_depth)
    rq = transform.inv_transform(deq, bit_depth, use_dst)
    rec = jnp.clip(pred + rq, 0, (1 << bit_depth) - 1)
    recon = recon.at[rows, cols].set(rec)
    coefp = coefp.at[rows, cols].set(lev)
    cbf = jnp.any(lev != 0, axis=(1, 2))
    return recon, coefp, best, cbf


def _enc_plane_ys(recon, orgp, pos, avail, modes, n, qp, c_idx,
                  bit_depth, strong, rdoq_cfg=None, sbh=False, rmd=True):
    """Like _enc_plane but returns the level block instead of scattering it
    into a dense coefficient plane (coef assembly happens once post-scan).
    rdoq_cfg: None for the plain dead-zone quantizer, or (init_type, lam)
    to run RDOQ level decisions (ops/rdoq.py). rmd=False promises every
    mode is already decided (modes >= 0) and skips the 35-mode SATD sweep
    (single-mode predict, TComPrediction.cpp predIntraLumaAng analog)."""
    log2 = n.bit_length() - 1
    chains = _gather_chains(recon, pos, n)
    chains = intra.substitute_refs(chains, avail, bit_depth)
    rows, cols = _block_idx(pos, n)
    org = orgp[rows, cols].astype(jnp.int32)
    if rmd:
        preds = intra.predict_all_modes(chains, n, c_idx, bit_depth, strong)
        costs = intra.satd(org[:, None], preds)
        best = jnp.argmin(costs, axis=1).astype(jnp.int32)
        best = jnp.where(modes >= 0, modes, best)
        pred = jnp.take_along_axis(preds, best[:, None, None, None],
                                   axis=1)[:, 0]
    else:
        best = modes
        pred = intra.predict_mode(chains, best, n, c_idx, bit_depth, strong)
    resi = org - pred
    use_dst = (n == 4 and c_idx == 0)
    coef = transform.fwd_transform(resi, bit_depth, use_dst)
    scan_id = _mdcs_scan_id(best, n, c_idx)
    if rdoq_cfg is None:
        lev = quant.quant(coef, qp, log2, bit_depth, True)
    else:
        init_type, lam = rdoq_cfg
        lev = rdoq.rdoq_quant(coef, scan_id, qp=qp, log2_size=log2,
                              bit_depth=bit_depth, c_idx=min(c_idx, 1),
                              init_type=init_type, lam=lam)
    if sbh:
        lev = quant.sbh_adjust(lev, scan_id, min(c_idx, 1), coef, qp,
                               bit_depth,
                               lam=rdoq_cfg[1] if rdoq_cfg else 0.0)
    deq = quant.dequant(lev, qp, log2, bit_depth)
    rq = transform.inv_transform(deq, bit_depth, use_dst)
    rec = jnp.clip(pred + rq, 0, (1 << bit_depth) - 1)
    recon = recon.at[rows, cols].set(rec)
    cbf = jnp.any(lev != 0, axis=(1, 2))
    return recon, lev.astype(jnp.int16), best, cbf


@functools.partial(jax.jit, static_argnames=("sizes", "qp", "qp_c",
                                             "bit_depth", "strong", "h",
                                             "hc_off", "use_rdoq",
                                             "init_type", "sbh", "rmd"))
def scan_encode(org_y, org_c, xs, sizes: tuple, qp: int, qp_c: int,
                bit_depth: int, strong: bool, h: int, hc_off: int,
                use_rdoq: bool = False, init_type: int = 2,
                sbh: bool = False, rmd: bool = True):
    """Single-program multi-size intra encode, transfer-lean flavor.

    org_y: [h+pad, w]; org_c: [2*hc_off, w//2] with cb rows [0, h//2) and cr
    rows [hc_off, hc_off + h//2) — cb and cr batch together (c_idx only
    separates luma from chroma). Dummy blocks target the scratch rows at
    y=h (luma) / y=h//2 (stacked chroma).

    xs: dict {log2: (pos [S,B,2], avail, availc, modes [S,B])}.
    Returns (ry, rc, coef_y int16 [:h], coef_c int16 stacked, outs) where
    outs[log2] = (modes [S,B], cbf_y [S,B], cbf_c [S,2B] (cb then cr)).
    """
    org_y = org_y.astype(jnp.int32)   # callers upload uint8/uint16
    org_c = org_c.astype(jnp.int32)
    ry = jnp.zeros_like(org_y)
    rc = jnp.zeros_like(org_c)
    hc = h // 2
    from hevc_hop_tpu.models import partition as _part
    rcfg_y = (init_type, _part.full_lambda(qp)) if use_rdoq else None
    rcfg_c = (init_type, _part.full_lambda(qp)
              * 2.0 ** ((qp_c - qp) / 3.0)) if use_rdoq else None

    def step(carry, x):
        ry, rc = carry
        ys = {}
        for log2 in sizes:
            n = 1 << log2
            if log2 == 2:
                p, al, ac, m, cmv = x[log2]
            else:
                p, al, ac, m = x[log2]
            ry, lev_y, best, cbf = _enc_plane_ys(
                ry, org_y, p, al, m, n, qp, 0, bit_depth, strong, rcfg_y,
                sbh, rmd=rmd)
            if log2 == 2:
                # NxN: the 4th PU carries the CU-level 4x4 chroma TU;
                # non-carriers predict into the chroma scratch rows
                carrier = (p[:, 0] % 8 == 4) & (p[:, 1] % 8 == 4)
                cup = jnp.where(carrier[:, None], (p - 4) // 2,
                                jnp.array([0, hc], jnp.int32))
                pcc = jnp.concatenate(
                    [cup, cup + jnp.array([0, hc_off], jnp.int32)], 0)
                acc = jnp.concatenate([ac, ac], 0)
                mc = jnp.concatenate([cmv, cmv], 0)
                rc, lev_c, _, cbf_c = _enc_plane_ys(
                    rc, org_c, pcc, acc, mc, 4, qp_c, 1, bit_depth,
                    strong, rcfg_c, sbh, rmd=False)
            else:
                pc = p // 2
                pc = pc.at[:, 1].set(jnp.where(p[:, 1] >= h, hc, pc[:, 1]))
                pcc = jnp.concatenate(
                    [pc, pc + jnp.array([0, hc_off], jnp.int32)], 0)
                acc = jnp.concatenate([ac, ac], 0)
                mc = jnp.concatenate([best, best], 0)
                rc, lev_c, _, cbf_c = _enc_plane_ys(
                    rc, org_c, pcc, acc, mc, n // 2, qp_c, 1, bit_depth,
                    strong, rcfg_c, sbh, rmd=False)
            ys[log2] = (lev_y, lev_c, best, cbf, cbf_c)
        return (ry, rc), ys

    (ry, rc), ys = jax.lax.scan(step, (ry, rc), xs)

    # dense coefficient assembly: ONE scatter per (size, plane)
    coef_y = jnp.zeros(org_y.shape, jnp.int16)
    coef_c = jnp.zeros(org_c.shape, jnp.int16)
    outs = {}
    for log2 in sizes:
        n = 1 << log2
        p = xs[log2][0]
        lev_y, lev_c, best, cbf, cbf_c = ys[log2]
        s, b = p.shape[:2]
        rows, cols = _block_idx(p.reshape(s * b, 2), n)
        coef_y = coef_y.at[rows, cols].set(lev_y.reshape(s * b, n, n))
        if log2 == 2:
            carrier = (p[..., 0] % 8 == 4) & (p[..., 1] % 8 == 4)
            cup = jnp.where(carrier[..., None], (p - 4) // 2,
                            jnp.array([0, hc], jnp.int32))
            pcc = jnp.concatenate(
                [cup, cup + jnp.array([0, hc_off], jnp.int32)], 1)
            mc2 = 4
        else:
            pc = p // 2
            pc = pc.at[:, :, 1].set(
                jnp.where(p[:, :, 1] >= h, hc, pc[:, :, 1]))
            pcc = jnp.concatenate(
                [pc, pc + jnp.array([0, hc_off], jnp.int32)], 1)
            mc2 = n // 2
        rows, cols = _block_idx(pcc.reshape(s * 2 * b, 2), mc2)
        coef_c = coef_c.at[rows, cols].set(
            lev_c.reshape(s * 2 * b, mc2, mc2))
        outs[log2] = (best, cbf, cbf_c)
    # int8 views halve the device->host coefficient traffic; the (rare)
    # frames with |level| > 127 raise `wide` and the caller fetches int16
    wide = (jnp.any(jnp.abs(coef_y.astype(jnp.int32)) > 127)
            | jnp.any(jnp.abs(coef_c.astype(jnp.int32)) > 127))
    coef8 = (jnp.clip(coef_y[:h], -128, 127).astype(jnp.int8),
             jnp.clip(coef_c, -128, 127).astype(jnp.int8))
    return ry, rc, coef_y[:h], coef_c, coef8, wide, outs


@functools.partial(jax.jit, static_argnames=("sizes", "bit_depth", "strong",
                                             "h"))
def scan_decode(resi_y, resi_cb, resi_cr, xs, sizes: tuple, bit_depth: int,
                strong: bool, h: int):
    """Single-program multi-size intra decode (prediction + dense residual).

    xs: dict {log2: (pos, avail, availc, modes, cmodes)}. Cb and cr batch
    through ONE stacked chroma plane (cr rows at +hc_off) so each step runs
    one chroma pass instead of two — a third fewer ops on the
    latency-bound wavefront.
    """
    hcp = resi_cb.shape[0]                 # h//2 + pad
    hc = h // 2
    resi_c = jnp.concatenate([resi_cb, resi_cr], 0)
    ry = jnp.zeros_like(resi_y)
    rc = jnp.zeros_like(resi_c)
    coff = jnp.array([0, hcp], jnp.int32)

    def dec_plane(recon, resip, p, al, m, nn, c_idx):
        chains = _gather_chains(recon, p, nn)
        chains = intra.substitute_refs(chains, al, bit_depth)
        pred = intra.predict_mode(chains, m, nn, c_idx, bit_depth, strong)
        rows, cols = _block_idx(p, nn)
        rec = jnp.clip(pred + resip[rows, cols], 0, (1 << bit_depth) - 1)
        return recon.at[rows, cols].set(rec)

    def step(carry, x):
        ry, rc = carry
        for log2 in sizes:
            n = 1 << log2
            p, al, ac, m, cm = x[log2]
            ry = dec_plane(ry, resi_y, p, al, m, n, 0)
            if log2 == 2:
                carrier = (p[:, 0] % 8 == 4) & (p[:, 1] % 8 == 4)
                pc = jnp.where(carrier[:, None], (p - 4) // 2,
                               jnp.array([0, hc], jnp.int32))
                mc2 = 4
            else:
                pc = p // 2
                pc = pc.at[:, 1].set(jnp.where(p[:, 1] >= h, hc, pc[:, 1]))
                mc2 = n // 2
            pcc = jnp.concatenate([pc, pc + coff], 0)
            acc = jnp.concatenate([ac, ac], 0)
            cmm = jnp.concatenate([cm, cm], 0)
            rc = dec_plane(rc, resi_c, pcc, acc, cmm, mc2, 1)
        return (ry, rc), None

    (ry, rc), _ = jax.lax.scan(step, (ry, rc), xs)
    return ry, rc[:hcp], rc[hcp:]
