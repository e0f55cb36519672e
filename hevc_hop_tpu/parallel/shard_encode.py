"""Mesh-sharded production intra encode: frame-DP x CTU-row bands.

The single-device encoder runs the whole-frame wavefront as one lax.scan
(models/wavefront_scan.scan_encode). Here the same program is partitioned
over a jax mesh ("frame", "band"):

  frame axis : independent frames, pure data parallelism
  band axis  : horizontal CTU-row bands of one frame. Intra prediction
               reads at most ONE reconstructed row above a block (the
               reference chain top row, TComPattern.cpp:179 initAdiPattern),
               so each band keeps a 1-row recon halo that is refreshed with
               a `ppermute` over the band axis after every wavefront step.
               The schedule levels are computed GLOBALLY (native
               wavefront_levels), so any block that depends on the band
               above sits at a strictly later level than its producer and
               reads the halo only after the exchange that carried it —
               the sharded encode is BIT-IDENTICAL to the single-device
               scan (asserted by tests/test_multichip.py and
               __graft_entry__.dryrun_multichip).

Capability ref: this is the batched replacement for the reference's
bitstream-level parallelization seams (WPP rows / tiles, SURVEY.md §2.5);
HM itself is single-threaded (TEncSlice.cpp:844).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hevc_hop_tpu.models import wavefront, wavefront_scan


def make_mesh(n_devices: int | None = None, band_par: int | None = None
              ) -> Mesh:
    devs = jax.devices()[:n_devices] if n_devices else jax.devices()
    n = len(devs)
    if band_par is None:
        band_par = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    return Mesh(np.array(devs).reshape(n // band_par, band_par),
                ("frame", "band"))


def build_banded_schedule(leaves, w: int, h: int, ctb_log2: int,
                          nbands: int):
    """Banded schedule: blocks slotted per (global wavefront level, band).

    Returns (sizes, data, nsteps, hb) with data[log2] = dict(
    pos [S, R, B, 2] BAND-LOCAL coords (row 0 = halo, rows 1..hb = band,
    dummies target the scratch row hb+1), avail/availc from GLOBAL
    availability, valid [S, R, B], modes slot map gpos [S, R, B, 2]
    (global coords for mode lookup; dummies (0, h)))."""
    from hevc_hop_tpu.entropy import native as _native
    assert h % (nbands << ctb_log2) == 0, "bands must be CTU-row aligned"
    hb = h // nbands
    arr = np.array(leaves, np.int32)
    levels = _native.wavefront_levels(arr[:, 0], arr[:, 1], arr[:, 2],
                                      w, h, ctb_log2)
    nsteps = int(levels.max()) if len(levels) else 0
    zplane = wavefront.zaddr4_plane(w, h, ctb_log2)
    czplane = zplane[::2, ::2]
    sizes = tuple(sorted({int(l) for l in arr[:, 2]}))
    data = {}
    for log2 in sizes:
        n = 1 << log2
        sel = arr[:, 2] == log2
        lv = levels[sel] - 1
        pts = arr[sel][:, :2]
        band = pts[:, 1] // hb
        key = lv * nbands + band
        counts = np.bincount(key, minlength=nsteps * nbands)
        bmax = max(1, int(counts.max()))
        gpos = np.zeros((nsteps, nbands, bmax, 2), np.int32)
        gpos[..., 1] = h                       # global dummy -> (0, h)
        valid = np.zeros((nsteps, nbands, bmax), bool)
        slot = np.zeros(nsteps * nbands, np.int32)
        for j in np.argsort(key, kind="stable"):
            k = key[j]
            gpos[lv[j], band[j], slot[k]] = pts[j]
            valid[lv[j], band[j], slot[k]] = True
            slot[k] += 1
        flat = gpos.reshape(-1, 2)
        vmf = valid.reshape(-1)
        fv = flat[vmf]
        avail = np.zeros((flat.shape[0], 4 * n + 1), bool)
        avail[vmf] = wavefront.avail_mask(fv, n, zplane, w, h)
        availc = np.zeros((flat.shape[0], 2 * n + 1), bool)
        availc[vmf] = wavefront.avail_mask(fv // 2, n // 2, czplane,
                                           w // 2, h // 2)
        # band-local coords: y_loc = y - band*hb + 1 (halo row 0);
        # dummies -> scratch row hb+1
        bidx = np.arange(nbands)[None, :, None]
        y_loc = np.where(valid, gpos[..., 1] - bidx * hb + 1, hb + 1)
        x_loc = np.where(valid, gpos[..., 0], 0)
        pos = np.stack([x_loc, y_loc], -1).astype(np.int32)
        data[log2] = dict(
            pos=pos, gpos=gpos, valid=valid,
            avail=avail.reshape(nsteps, nbands, bmax, 4 * n + 1),
            availc=availc.reshape(nsteps, nbands, bmax, 2 * n + 1))
    return sizes, data, nsteps, hb


def banded_encode_fn(mesh: Mesh, sizes: tuple, qp: int, qp_c: int,
                     bit_depth: int, strong: bool, hb: int, w: int,
                     use_rdoq: bool, init_type: int, sbh: bool, rmd: bool):
    """Compiled mesh program: (org_y [F,R,slab,w], org_c [F,R,cslab,w/2],
    xs {log2: (pos [S,R,B,2], avail, availc, modes [S,R,B])}) ->
    (ry [F,h,w], rc_cb [F,h/2,w/2], rc_cr, coef_y [F,h,w] int16,
    coef_cb, coef_cr, outs {log2: (best [S,R,B], cbf, cbf_c [S,R,2B])}).

    slab layout (luma): row 0 halo, rows 1..hb band rows, hb+1.. scratch.
    chroma stacked cb/cr with hcoff = hb//2 + 2 + 16.
    """
    from hevc_hop_tpu.models.wavefront_scan import (_enc_plane_ys,
                                                    _block_idx)
    from hevc_hop_tpu.models import partition as _part
    from jax import shard_map

    hcb = hb // 2
    hcoff = hcb + 2 + 16
    rcfg_y = (init_type, _part.full_lambda(qp)) if use_rdoq else None
    rcfg_c = (init_type, _part.full_lambda(qp)
              * 2.0 ** ((qp_c - qp) / 3.0)) if use_rdoq else None

    def local(org_y, org_c, xs):
        org_y = org_y[0, 0].astype(jnp.int32)     # [slab, w]
        org_c = org_c[0, 0].astype(jnp.int32)
        xs = {k: tuple(a[:, 0] for a in v) for k, v in xs.items()}
        nb = jax.lax.axis_size("band")
        bidx = jax.lax.axis_index("band")
        ry = jnp.zeros_like(org_y)
        rc = jnp.zeros_like(org_c)
        perm = [(i, i + 1) for i in range(nb - 1)]

        def step(carry, x):
            ry, rc = carry
            ys = {}
            for log2 in sizes:
                n = 1 << log2
                p, al, ac, m = x[log2]
                ry, lev_y, best, cbf = _enc_plane_ys(
                    ry, org_y, p, al, m, n, qp, 0, bit_depth, strong,
                    rcfg_y, sbh, rmd=rmd)
                # chroma local coords: cy = (y_loc-1)//2 + 1
                pc = jnp.stack([p[:, 0] // 2, (p[:, 1] - 1) // 2 + 1], -1)
                pcc = jnp.concatenate(
                    [pc, pc + jnp.array([0, hcoff], jnp.int32)], 0)
                acc = jnp.concatenate([ac, ac], 0)
                mc = jnp.concatenate([best, best], 0)
                rc, lev_c, _, cbf_c = _enc_plane_ys(
                    rc, org_c, pcc, acc, mc, n // 2, qp_c, 1, bit_depth,
                    strong, rcfg_c, sbh, rmd=False)
                ys[log2] = (lev_y, lev_c, best, cbf, cbf_c)
            # halo refresh: last real rows -> next band's halo rows
            if nb > 1:
                hy = jax.lax.ppermute(ry[hb], "band", perm)
                ry = ry.at[0].set(jnp.where(bidx == 0, ry[0], hy))
                hcrows = jnp.stack([rc[hcb], rc[hcoff + hcb]], 0)
                hc = jax.lax.ppermute(hcrows, "band", perm)
                keep = jnp.stack([rc[0], rc[hcoff]], 0)
                hc = jnp.where(bidx == 0, keep, hc)
                rc = rc.at[0].set(hc[0]).at[hcoff].set(hc[1])
            return (ry, rc), ys

        (ry, rc), ys = jax.lax.scan(step, (ry, rc), xs)

        # dense coef assembly per band (slab coords), then crop band rows
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
            pc = jnp.stack([p[..., 0] // 2, (p[..., 1] - 1) // 2 + 1], -1)
            pcc = jnp.concatenate(
                [pc, pc + jnp.array([0, hcoff], jnp.int32)], 1)
            rows, cols = _block_idx(pcc.reshape(s * 2 * b, 2), n // 2)
            coef_c = coef_c.at[rows, cols].set(
                lev_c.reshape(s * 2 * b, n // 2, n // 2))
            outs[log2] = (best[None, :, None], cbf[None, :, None],
                          cbf_c[None, :, None])
        return (ry[None, 1:hb + 1], rc[None, 1:hcb + 1],
                rc[None, hcoff + 1:hcoff + hcb + 1],
                coef_y[None, 1:hb + 1], coef_c[None, 1:hcb + 1],
                coef_c[None, hcoff + 1:hcoff + hcb + 1], outs)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P("frame", "band"), P("frame", "band"),
                  {log2: (P(None, "band"),) * 4 for log2 in sizes}),
        out_specs=((P("frame", "band"),) * 6
                   + ({log2: (P("frame", None, "band"),) * 3
                       for log2 in sizes},)))
    return jax.jit(fn)


class MeshIntraEncoder:
    """Frame-DP x row-band mesh encoder producing the SAME streams as the
    single-device IntraEncoder (uniform-CU in-loop-RMD configuration)."""

    def __init__(self, cfg, mesh: Mesh) -> None:
        from hevc_hop_tpu.models.encoder import IntraEncoder
        assert cfg.cu_log2 is not None, \
            "mesh encoder shares one static schedule: use uniform cu_log2"
        self.cfg = cfg
        self.mesh = mesh
        self.nbands = mesh.devices.shape[1]
        self.nframes = mesh.devices.shape[0]
        self.single = IntraEncoder(cfg)   # headers + maps plumbing
        self._built = None

    def _build(self):
        if self._built is not None:
            return self._built
        cfg = self.cfg
        w, h = cfg.width, cfg.height
        depth8 = np.full((h // 8, w // 8), cfg.ctb_log2 - cfg.cu_log2,
                         np.uint8)
        leaves = wavefront.leaves_from_depth(depth8, w, h, cfg.ctb_log2)
        sizes, data, nsteps, hb = build_banded_schedule(
            leaves, w, h, cfg.ctb_log2, self.nbands)
        xs = {}
        for log2 in sizes:
            d = data[log2]
            m = np.full(d["pos"].shape[:3], -1, np.int32)
            xs[log2] = (jnp.asarray(d["pos"]), jnp.asarray(d["avail"]),
                        jnp.asarray(d["availc"]), jnp.asarray(m))
        from hevc_hop_tpu.common import rom
        fn = banded_encode_fn(
            self.mesh, sizes, cfg.qp, rom.chroma_qp_from_luma(cfg.qp),
            cfg.bit_depth, cfg.strong_intra_smoothing, hb, w,
            cfg.rdoq, 2, cfg.sbh, rmd=True)
        self._built = (sizes, data, hb, xs, fn, depth8)
        return self._built

    def encode_frames(self, frames: list) -> list:
        """frames: list of (y, cb, cr) numpy, len == mesh frame dim.
        Returns list of AnnexB streams (bit-identical to IntraEncoder
        in the same uniform-CU config)."""
        from hevc_hop_tpu.common.types import SliceType, NalUnitType
        from hevc_hop_tpu.bitstream import nal, params, sei
        from hevc_hop_tpu.entropy import ctx_layout, native
        from hevc_hop_tpu.ops import deblock as dbk, hashes
        cfg = self.cfg
        w, h = cfg.width, cfg.height
        sizes, data, hb, xs, fn, depth8 = self._build()
        assert len(frames) == self.nframes
        slab = hb + 2 + 32
        cslab = 2 * (hb // 2 + 2 + 16)
        udt = np.uint8 if cfg.bit_depth <= 8 else np.uint16
        oy = np.zeros((self.nframes, self.nbands, slab, w), udt)
        oc = np.zeros((self.nframes, self.nbands, cslab, w // 2), udt)
        hcoff = hb // 2 + 2 + 16
        for f, (y, cb, cr) in enumerate(frames):
            for b in range(self.nbands):
                oy[f, b, 1:hb + 1] = y[b * hb:(b + 1) * hb]
                oc[f, b, 1:hb // 2 + 1] = cb[b * hb // 2:(b + 1) * hb // 2]
                oc[f, b, hcoff + 1:hcoff + hb // 2 + 1] = \
                    cr[b * hb // 2:(b + 1) * hb // 2]
        shard = NamedSharding(self.mesh, P("frame", "band"))
        oy = jax.device_put(oy, shard)
        oc = jax.device_put(oc, shard)
        ry, rcb, rcr, cy, ccb, ccr, outs = fn(oy, oc, xs)

        # loop filter on the sharded full-frame recon: XLA/GSPMD inserts
        # the band-halo collectives for the stencil reads automatically
        from hevc_hop_tpu.common import rom as _rom
        qp_c_v = _rom.chroma_qp_from_luma(cfg.qp)
        tu4 = np.full((h // 4, w // 4), cfg.cu_log2, np.uint8)
        recons = []
        for f in range(self.nframes):
            if cfg.deblocking:
                recons.append(dbk.deblock_frame(
                    ry[f], rcb[f], rcr[f], jnp.asarray(tu4), qp=cfg.qp,
                    qp_c=qp_c_v, bit_depth=cfg.bit_depth))
            else:
                recons.append((ry[f], rcb[f], rcr[f]))

        cy, ccb, ccr, outs_np = jax.device_get((cy, ccb, ccr, outs))
        streams = []
        enc = self.single
        for f in range(self.nframes):
            maps = native.SliceMaps(w, h, cfg.ctb_log2, max_hier_depth=0)
            maps.sbh = int(cfg.sbh)
            maps.depth8[:] = depth8
            maps.tu4[:] = tu4
            maps.coef_y[:] = cy[f]
            maps.coef_cb[:] = ccb[f]
            maps.coef_cr[:] = ccr[f]
            for log2 in sizes:
                d = data[log2]
                # outs arrays: [F, S, R, B] (cbf_c: [F, S, R, 2B])
                best, cbf, cbf_c = (a[f] for a in outs_np[log2])
                vm = d["valid"].reshape(-1)
                px = d["gpos"][..., 0].reshape(-1)[vm]
                py = d["gpos"][..., 1].reshape(-1)[vm]
                s, r, b = d["valid"].shape
                n = 1 << log2
                u4 = n // 4
                iy4 = py[:, None, None] // 4 + np.arange(u4)[None, :, None]
                ix4 = px[:, None, None] // 4 + np.arange(u4)[None, None, :]
                u8 = n // 8
                iy8 = py[:, None, None] // 8 + np.arange(u8)[None, :, None]
                ix8 = px[:, None, None] // 8 + np.arange(u8)[None, None, :]
                ccsel = cbf_c.reshape(s, r, 2, b)
                maps.mode4[iy4, ix4] = best.reshape(-1)[vm][:, None, None]
                maps.cbf4_y[iy4, ix4] = cbf.reshape(-1)[vm][
                    :, None, None].astype(np.uint8)
                maps.cbf8_cb[iy8, ix8] = ccsel[:, :, 0].reshape(-1)[vm][
                    :, None, None].astype(np.uint8)
                maps.cbf8_cr[iy8, ix8] = ccsel[:, :, 1].reshape(-1)[vm][
                    :, None, None].astype(np.uint8)
            sh = params.SliceHeader(slice_type=SliceType.I, slice_qp=cfg.qp)
            hw = params.write_slice_header(sh, enc.sps, enc.pps)
            states = ctx_layout.init_states(int(SliceType.I), cfg.qp)
            payload = native.encode_slice_data(states, maps)
            hw.write_bytes(payload)
            slice_nal = nal.make_nal(NalUnitType.IDR_W_RADL, hw.get_bytes())
            dig = hashes.checksum_digests(*recons[f], cfg.bit_depth)
            sei_nal = nal.make_nal(
                NalUnitType.SUFFIX_SEI_NUT,
                sei.write_sei([sei.SEIMessage(
                    sei.PICTURE_HASH,
                    sei.make_picture_hash_payload(dig, sei.HASH_CHECKSUM))]))
            streams.append(nal.annexb_wrap(
                enc.headers() + [slice_nal, sei_nal]))
        self.last_recons = recons
        return streams
