"""ISS/PSS CU-quadtree partition decision as a batched pre-pass.

Capability ref: the reference's recursive per-depth RD tournament
(TEncCu.cpp:371 xCompressCU: evaluate merge/inter/intra at each depth,
recurse, keep the cheaper tree, :1557 xCheckBestMode). A sequential
tournament cannot run inside the batched wavefront without serializing it, so
the tree choice is made in a *pre-pass* (SURVEY.md §7.1 "batched mode
evaluation + bottom-up DP"): for every CU size, every block's best
intra-vs-SS(-vs-temporal) RD cost is computed at once against the ORIGINAL
frame as a stand-in for the causal recon (exact causal masking, org pixel
values; the approximation error is the quantization noise of the reference
area), then a bottom-up min-DP picks the depth map. The real wavefront
scan (ss_scan.py) then encodes the chosen tree against the true recon.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from hevc_hop_tpu.models import partition, ss_scan, wavefront
from hevc_hop_tpu.ops import quant as q_ops
from hevc_hop_tpu.ops import transform as t_ops


def _level_bits(lev: jnp.ndarray) -> jnp.ndarray:
    """Coefficient-rate proxy identical to partition.rd_costs'."""
    a = jnp.abs(lev).astype(jnp.float32)
    bits = jnp.sum(jnp.where(a > 0, 3.0 + 2.0 * jnp.log2(a + 1.0), 0.0),
                   axis=(1, 2))
    nz = jnp.any(lev != 0, axis=(1, 2))
    return bits + jnp.where(nz, 10.0, 1.0)


@functools.partial(jax.jit, static_argnames=(
    "n", "qp", "bit_depth", "radius", "radius_t", "w", "h", "mi_size",
    "temporal"))
def _ss_rd_size(org_y, ref_y, pos, zcur, zmaxw, n: int, qp: int,
                bit_depth: int, radius: int, radius_t: int, w: int, h: int,
                mi_size: int, temporal: bool):
    """RD cost of the best inter arm (SS full search on the org plane,
    optional temporal arm on ref_y) for every n-block: transform/quant
    residual -> distortion + level bits + MV rate. Returns cost [B]."""
    lam = partition.full_lambda(qp)
    log2 = n.bit_length() - 1
    b = pos.shape[0]
    rows, cols = ss_scan._block_idx(pos, n)
    org = org_y[rows, cols]

    dmi = -(((n + mi_size - 1) // mi_size) * mi_size) * 4 if mi_size else 0
    preds = jnp.asarray([[0, 0], [dmi, 0], [0, dmi], [dmi, dmi]], jnp.int32)
    preds = jnp.broadcast_to(preds[None], (b, 4, 2))
    rate_map = ss_scan._dyn_rate_map(preds, radius, lam)
    mv, cost, pred, sse, _, _, _ = ss_scan._ss_search(
        org_y, org, pos, zcur, zmaxw, rate_map, n, radius, w, h, None)
    mv_rate = cost - sse
    best_cost = cost
    if temporal:
        # temporal arm uses ITS radius (search_range_t), not the SS one
        # (advisor round-4: the mismatch skewed PSS partition decisions)
        tpreds = jnp.broadcast_to(
            jnp.zeros((1, 1, 2), jnp.int32), (b, 1, 2))
        trate_map = ss_scan._dyn_rate_map(tpreds, radius_t, lam)
        mv_t, tcost, tpred, tsse = ss_scan._t_search(
            ref_y, org, pos, trate_map, n, radius_t, w, h)
        use_t = tcost < cost
        pred = jnp.where(use_t[:, None, None], tpred, pred)
        mv_rate = jnp.where(use_t, tcost - tsse, mv_rate)
        best_cost = jnp.minimum(cost, tcost)

    resi = org - pred
    coef = t_ops.fwd_transform(resi, bit_depth, use_dst=False)
    lev = q_ops.quant(coef, qp, log2, bit_depth, True)
    deq = q_ops.dequant(lev, qp, log2, bit_depth)
    rq = t_ops.inv_transform(deq, bit_depth, use_dst=False)
    err = (resi - rq).astype(jnp.float32)
    dist = jnp.sum(err * err, axis=(1, 2))
    out = dist + lam * _level_bits(lev) + mv_rate
    # fully-masked blocks (no causal candidate): force the intra arm
    return jnp.where(best_cost < jnp.float32(1e37), out, jnp.float32(3e38))


def decide(y: np.ndarray, qp: int, ctb_log2: int, radius: int,
           mi_size: int, bit_depth: int = 8,
           ref_y: np.ndarray | None = None, radius_t: int | None = None):
    """Quadtree depth map [h//8, w//8] + per-4x4 intra mode map for an
    ISS (ref_y None) or PSS picture. Luma-only decision (chroma follows),
    CU sizes 8/16/32. The RD-chosen intra modes feed the wavefront scan
    so its intra arm skips the 35-mode sweep (estIntraPredQT analog)."""
    h, w = y.shape
    org = jnp.asarray(y, jnp.int32)
    ref = jnp.asarray(ref_y, jnp.int32) if ref_y is not None else org
    zplane4 = wavefront.zaddr4_plane(w, h, ctb_log2)
    costs, modes = {}, {}
    for log2 in (3, 4, 5):
        n = 1 << log2
        by, bx = h // n, w // n
        ys = (np.arange(by) * n)[:, None].repeat(bx, 1).ravel()
        xs = (np.arange(bx) * n)[None, :].repeat(by, 0).ravel()
        pos = jnp.asarray(np.stack([xs, ys], -1), jnp.int32)
        zcur = jnp.asarray(zplane4[ys >> 2, xs >> 2].astype(np.int32))
        zmaxw = jnp.asarray(ss_scan.zmax_win_px(zplane4, n))
        icost, imode = partition.rd_costs(org, n, qp, bit_depth)
        scost = _ss_rd_size(org, ref, pos, zcur, zmaxw, n, qp,
                            bit_depth, radius,
                            radius_t if radius_t is not None else radius,
                            w, h, mi_size,
                            ref_y is not None).reshape(by, bx)
        costs[log2] = jnp.minimum(icost, scost)
        modes[log2] = imode
    depth8, mode8 = partition.decide(costs[3], costs[4], costs[5],
                                     modes[3], modes[4], modes[5], qp,
                                     ctb_log2)
    depth8, mode8 = np.asarray(depth8), np.asarray(mode8)
    mode4 = np.repeat(np.repeat(mode8, 2, 0), 2, 1).astype(np.int32)
    return depth8, mode4
