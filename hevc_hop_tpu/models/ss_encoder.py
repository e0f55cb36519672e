"""Holoscopic (lenslet light-field) encoder: ISS slices with SS prediction.

Capability ref: the IT extension's HoloscopicIntra path — slice type ISS
(TEncSlice.cpp:292-308), the picture's own causal recon as the single L0
reference (TComSlice.cpp:366-377), full-search SS ME with causal validity
(TEncSearch.cpp:6224-6352), per-CU recon feeding later CUs' prediction
(TEncCu.cpp:870-880), VPS holoscopic extension signalling
(TEncCavlc.cpp:572-575), MI merge candidates via vps_holo_microimage_size
(TComDataCU.cpp:2642-2712).

Structure: intra + SS tournament fused into one lax.scan
wavefront (models/ss_scan.py); the native C++ serializer turns final MVs
into skip/merge/AMVP syntax (native/cabac.cpp code_inter_cu).
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from hevc_hop_tpu.bitstream import nal, params
from hevc_hop_tpu.common import rom
from hevc_hop_tpu.common.types import NalUnitType, SliceType
from hevc_hop_tpu.entropy import ctx_layout, native
from hevc_hop_tpu.io import yuv as yuvio
from hevc_hop_tpu.models import partition, ss_scan
from hevc_hop_tpu.ops import deblock


def _mi_avail(pos: np.ndarray, valid: np.ndarray, n: int, mi: int,
              ctb: int) -> np.ndarray:
    """Static availability of the three MI merge/AMVP candidates per
    scheduled block [S, B, 3] (getMILeftCand/Above/AboveLeft,
    TComDataCU.cpp:2642-2712 + isMvInsidePic bound, :2627)."""
    if mi <= 0:
        return np.zeros(pos.shape[:2] + (3,), bool)
    d = -(((n + mi - 1) // mi) * mi) * 4          # qpel MI displacement
    x, y = pos[..., 0], pos[..., 1]
    ok_h = d >= (-ctb - 8 - x + 1) * 4
    ok_v = d >= (-ctb - 8 - y + 1) * 4
    left = (x % ctb != 0) & ok_h
    above = (y % ctb != 0) & ok_v
    al = (x % ctb != 0) & ok_h & ok_v
    return np.stack([left, above, al], -1) & valid[..., None]


@dataclasses.dataclass
class HoloConfig:
    width: int = 64
    height: int = 64
    qp: int = 32
    bit_depth: int = 8
    ctb_log2: int = 5
    cu_log2: int = 4            # uniform CU grid (when quadtree=False)
    quadtree: bool = False      # per-frame CU quadtree 8/16/32 via the
                                # batched RD pre-pass (ss_partition.decide,
                                # TEncCu.cpp:371 xCompressCU analog);
                                # needs CTB-aligned dimensions
    search_range: int = 32      # SS full-search radius (SearchRange cfg)
    search_range_t: int = 16    # temporal ME radius (PSS frames)
    mi_size: int = 0            # micro-image size (MIsize cfg; 0 = off)
    gt: bool = True             # GT/HOP corner-warp refinement (IT_GT)
    strong_intra_smoothing: bool = True
    deblocking: bool = True
    sao: bool = False
    # RDOQ level decisions (TComTrQuant.cpp:1489 xRateDistOptQuant analog)
    rdoq: bool = True
    # sign_data_hiding_enabled_flag (TComTrQuant.cpp:868 signBitHidingHDQ)
    sbh: bool = True
    # decoded-picture-hash SEI type: checksum is a device-side reduction
    # (no recon transfer); MD5 forces a full-frame fetch
    hash_type: int = 2  # sei.HASH_CHECKSUM


class HoloEncoder:
    """All-ISS encoder (HoloscopicIntra:1 semantics, GOPSize 1)."""

    def __init__(self, cfg: HoloConfig) -> None:
        assert cfg.width % 8 == 0 and cfg.height % 8 == 0
        assert cfg.cu_log2 >= 3, "ISS CUs are 8x8+ (4x4 NxN TODO)"
        self.cfg = cfg
        if cfg.sao:
            assert cfg.width % (1 << cfg.ctb_log2) == 0 \
                and cfg.height % (1 << cfg.ctb_log2) == 0, \
                "SAO stats tiling needs CTU-aligned dims (pad input)"
        self.sps = params.SPS(
            pic_width=cfg.width, pic_height=cfg.height,
            bit_depth=cfg.bit_depth, ctb_log2=cfg.ctb_log2,
            max_transform_hierarchy_depth_intra=0,
            sao_enabled=cfg.sao,
            strong_intra_smoothing=cfg.strong_intra_smoothing)
        self.pps = params.PPS(init_qp=26,
                              sign_data_hiding=cfg.sbh,
                              deblocking_disabled=not cfg.deblocking)
        self.vps = params.VPS(holo=True, holo_mi_size=cfg.mi_size)

    def headers(self) -> list:
        return [
            nal.make_nal(NalUnitType.VPS_NUT, params.write_vps(self.vps)),
            nal.make_nal(NalUnitType.SPS_NUT, params.write_sps(self.sps)),
            nal.make_nal(NalUnitType.PPS_NUT, params.write_pps(self.pps)),
        ]

    def encode_sequence(self, frames: list) -> bytes:
        """Low-delay holoscopic GOP: ISS IDR + PSS trail pictures
        (GOP type 'H', TEncGOP.cpp:623-626). frames: [(y, cb, cr), ...]."""
        out = [self.encode_frame(*frames[0])]
        self.recon_history = [self.recon_yuv]
        for poc, (y, cb, cr) in enumerate(frames[1:], start=1):
            out.append(self._encode_pss(y, cb, cr, poc))
            self.recon_history.append(self.recon_yuv)
        return b"".join(out)

    def _prep(self, leaves=None, key=None):
        """Schedule + static search planes + scatter indices, cached per
        partition (HM re-derives per CTU, TEncSlice.cpp:1000). leaves=None
        -> the uniform cu_log2 grid; otherwise a decided quadtree, cached
        under `key` (depth-map digest)."""
        cache = getattr(self, "_prep_cache", None)
        if cache is None:
            cache = self._prep_cache = collections.OrderedDict()
        if key in cache:
            cache.move_to_end(key)
            return cache[key]
        cfg = self.cfg
        w, h = cfg.width, cfg.height
        n = 1 << cfg.cu_log2
        radius = cfg.search_range
        if leaves is None:
            leaves = [(x, yy, cfg.cu_log2)
                      for cy in range(0, h, 1 << cfg.ctb_log2)
                      for cx in range(0, w, 1 << cfg.ctb_log2)
                      for yy in range(cy, min(cy + (1 << cfg.ctb_log2), h), n)
                      for x in range(cx, min(cx + (1 << cfg.ctb_log2), w), n)]
        sizes, data, _ = ss_scan.build_schedule_ss(
            leaves, w, h, cfg.ctb_log2, radius)
        zplane4 = ss_scan.wavefront.zaddr4_plane(w, h, cfg.ctb_log2)
        zmaxw, zmax2n, xs, scat = {}, {}, {}, {}
        for log2 in sizes:
            nn = 1 << log2
            d = data[log2]
            zmaxw[log2] = jnp.asarray(ss_scan.zmax_win_px(zplane4, nn))
            zmax2n[log2] = jnp.asarray(
                ss_scan.zmax_win_px(zplane4, 2 * nn, ifm=2)) if cfg.gt \
                else jnp.zeros((1, 1), jnp.int32)
            miav = _mi_avail(d["pos"], d["valid"], nn, cfg.mi_size,
                             1 << cfg.ctb_log2)
            xs[log2] = (jnp.asarray(d["pos"]), jnp.asarray(d["avail"]),
                        jnp.asarray(d["availc"]), jnp.asarray(d["zcur"]),
                        jnp.asarray(d["nbav"]), jnp.asarray(miav))
            # vectorized scatter indices (valid leaves only)
            vm = d["valid"].ravel()
            px = d["pos"][..., 0].ravel()[vm]
            py = d["pos"][..., 1].ravel()[vm]
            u4 = nn // 4
            iy4 = py[:, None, None] // 4 + np.arange(u4)[None, :, None]
            ix4 = px[:, None, None] // 4 + np.arange(u4)[None, None, :]
            u8 = nn // 8
            iy8 = py[:, None, None] // 8 + np.arange(u8)[None, :, None]
            ix8 = px[:, None, None] // 8 + np.arange(u8)[None, None, :]
            scat[log2] = (vm, px, py, iy4, ix4, iy8, ix8)
        prep = (sizes, data, zmaxw, zmax2n, xs, scat)
        cache[key] = prep
        # bounded LRU: distinct per-frame partitions otherwise accumulate
        # schedules AND XLA executables without end (advisor round-4)
        while len(cache) > 4:
            cache.popitem(last=False)
        return prep

    def _frame_prep(self, y: np.ndarray, ref_y=None):
        """Per-frame partition + intra-mode choice (quadtree pre-pass).

        Returns (prep, mode4 or None): mode4 carries the pre-pass's
        RD-chosen intra modes into the scan (fixed_mode path)."""
        cfg = self.cfg
        if not cfg.quadtree:
            return self._prep(), None
        from hevc_hop_tpu.models import ss_partition, wavefront
        assert cfg.width % (1 << cfg.ctb_log2) == 0 \
            and cfg.height % (1 << cfg.ctb_log2) == 0, \
            "quadtree mode needs CTB-aligned dims"
        depth8, mode4 = ss_partition.decide(
            np.asarray(y), cfg.qp, cfg.ctb_log2, cfg.search_range,
            cfg.mi_size, cfg.bit_depth, ref_y,
            radius_t=cfg.search_range_t)
        self._depth8 = depth8
        leaves = wavefront.leaves_from_depth(
            depth8, cfg.width, cfg.height, cfg.ctb_log2)
        return self._prep(leaves, key=depth8.tobytes()), mode4

    @staticmethod
    def _xs_with_modes(xs, data, sizes, mode4):
        """Append the per-block pre-pass intra mode to each size's xs."""
        out = {}
        for log2 in sizes:
            d = data[log2]
            px = np.where(d["valid"], d["pos"][..., 0], 0)
            py = np.where(d["valid"], d["pos"][..., 1], 0)
            im = np.where(d["valid"], mode4[py // 4, px // 4],
                          0).astype(np.int32)
            out[log2] = xs[log2] + (jnp.asarray(im),)
        return out

    def _upload(self, y, cb, cr):
        cfg = self.cfg
        w, h = cfg.width, cfg.height
        pad = 1 << cfg.ctb_log2
        udt = np.uint8 if cfg.bit_depth <= 8 else np.uint16
        org_y = jnp.zeros((h + pad, w), jnp.int32).at[:h].set(
            jnp.asarray(np.ascontiguousarray(y, udt)).astype(jnp.int32))
        org_cb = jnp.zeros((h // 2 + pad, w // 2), jnp.int32).at[:h // 2].set(
            jnp.asarray(np.ascontiguousarray(cb, udt)).astype(jnp.int32))
        org_cr = jnp.zeros((h // 2 + pad, w // 2), jnp.int32).at[:h // 2].set(
            jnp.asarray(np.ascontiguousarray(cr, udt)).astype(jnp.int32))
        return org_y, org_cb, org_cr

    @staticmethod
    def _fetch_all(coef_y, coef_cb, coef_cr, outs, h):
        """ONE batched device->host roundtrip for the coefficient planes
        (int16 over the wire) and all per-block entropy outputs."""
        return jax.device_get(
            (coef_y[:h].astype(jnp.int16),
             coef_cb[:h // 2].astype(jnp.int16),
             coef_cr[:h // 2].astype(jnp.int16), outs))

    def _fill_maps(self, maps, sizes, scat, outs, pss: bool):
        """Dense syntax maps from per-step outputs: ONE vectorized scatter
        per (size, map) instead of per-leaf Python loops."""
        for log2 in sizes:
            vm_, px_, py_, iy4_, ix4_, iy8_, ix8_ = scat[log2]
            maps.depth8[iy8_, ix8_] = self.cfg.ctb_log2 - log2
            maps.tu4[iy4_, ix4_] = log2
        for log2 in sizes:
            if pss:
                (inter, refsel, mv, imode, cbf, cbf_b, cbf_r,
                 gtflag, gtc) = outs[log2]
            else:
                inter, mv, imode, cbf, cbf_b, cbf_r, gtflag, gtc = outs[log2]
                refsel = None
            vm, px, py, iy4, ix4, iy8, ix8 = scat[log2]
            e = lambda a: np.asarray(a).reshape(-1)[vm]
            iv = e(inter)
            mvx = np.asarray(mv[..., 0]).reshape(-1)[vm]   # quarter-pel
            mvy = np.asarray(mv[..., 1]).reshape(-1)[vm]
            col = lambda v: v[:, None, None]
            maps.pred4[iy4, ix4] = col(np.where(iv, 0, 1).astype(np.uint8))
            maps.mode4[iy4, ix4] = col(
                np.where(iv, 1, e(imode)).astype(np.uint8))
            maps.mv4x[iy4, ix4] = col(np.where(iv, mvx, 0).astype(np.int16))
            maps.mv4y[iy4, ix4] = col(np.where(iv, mvy, 0).astype(np.int16))
            maps.cbf4_y[iy4, ix4] = col(e(cbf).astype(np.uint8))
            if refsel is not None:
                maps.ref4[iy4, ix4] = col(
                    np.where(iv, e(refsel), 0).astype(np.uint8))
            maps.cbf8_cb[iy8, ix8] = col(e(cbf_b).astype(np.uint8))
            maps.cbf8_cr[iy8, ix8] = col(e(cbf_r).astype(np.uint8))
            gf = e(gtflag)
            gv = np.asarray(gtc).reshape(-1, 6)[vm]
            maps.gt8[py // 8, px // 8] = gf.astype(np.uint8)
            maps.gtv8[py // 8, px // 8] = \
                np.where(gf[:, None], gv, 0).astype(np.int16)

    def encode_frame(self, y: np.ndarray, cb: np.ndarray,
                     cr: np.ndarray) -> bytes:
        cfg = self.cfg
        w, h = cfg.width, cfg.height
        qp, qp_c = cfg.qp, rom.chroma_qp_from_luma(cfg.qp)
        radius = cfg.search_range
        (sizes, data, zmaxw, zmax2n, xs, scat), mode4 = self._frame_prep(y)
        if mode4 is not None:
            xs = self._xs_with_modes(xs, data, sizes, mode4)
        org_y, org_cb, org_cr = self._upload(y, cb, cr)

        ry, rcb, rcr, coef_y, coef_cb, coef_cr, outs = ss_scan.scan_encode_iss(
            org_y, org_cb, org_cr, xs, zmaxw, zmax2n,
            sizes=sizes, qp=qp, qp_c=qp_c, bit_depth=cfg.bit_depth,
            strong=cfg.strong_intra_smoothing, w=w, h=h, radius=radius,
            mi_size=cfg.mi_size, gt=cfg.gt, use_rdoq=cfg.rdoq,
            sbh=cfg.sbh, fixed_mode=mode4 is not None)

        maps = native.SliceMaps(w, h, cfg.ctb_log2, max_hier_depth=0)
        maps.slice_type = int(SliceType.ISS)
        maps.sbh = int(cfg.sbh)
        maps.mi_size = cfg.mi_size
        cy_np, ccb_np, ccr_np, outs = self._fetch_all(
            coef_y, coef_cb, coef_cr, outs, h)
        maps.coef_y[:] = cy_np
        maps.coef_cb[:] = ccb_np
        maps.coef_cr[:] = ccr_np
        self._fill_maps(maps, sizes, scat, outs, pss=False)

        ry, rcb, rcr = ry[:h], rcb[:h // 2], rcr[:h // 2]
        if cfg.deblocking:
            ry, rcb, rcr = deblock.deblock_frame(
                ry, rcb, rcr, jnp.asarray(maps.tu4), qp=qp, qp_c=qp_c,
                bit_depth=cfg.bit_depth, pred4=maps.pred4,
                cbf4=maps.cbf4_y, ref4=maps.ref4, mv4x=maps.mv4x,
                mv4y=maps.mv4y)
        if cfg.sao:
            from hevc_hop_tpu.ops import sao as saop
            ry, rcb, rcr = saop.rdo_and_apply(
                (org_y[:h], org_cb[:h // 2], org_cr[:h // 2]),
                (ry, rcb, rcr), maps, cfg.ctb_log2,
                partition.full_lambda(qp), cfg.bit_depth)
        self._recon_dev = (ry, rcb, rcr)
        self._recon_np = None

        self.last_maps = maps
        sh = params.SliceHeader(slice_type=SliceType.ISS, slice_qp=qp)
        hw = params.write_slice_header(sh, self.sps, self.pps)
        states = ctx_layout.init_states(int(SliceType.ISS), qp)
        payload = native.encode_slice_data_ss(states, maps)
        hw.write_bytes(payload)
        slice_nal = nal.make_nal(NalUnitType.IDR_W_RADL, hw.get_bytes())
        return nal.annexb_wrap(self.headers()
                               + [slice_nal, self._hash_sei()])

    def _encode_pss(self, y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                    poc: int) -> bytes:
        """One PSS picture: L0 = [previous filtered recon, SS ref(last)]."""
        cfg = self.cfg
        w, h = cfg.width, cfg.height
        qp, qp_c = cfg.qp, rom.chroma_qp_from_luma(cfg.qp)
        radius = cfg.search_range
        (sizes, data, zmaxw, zmax2n, xs, scat), mode4 = self._frame_prep(
            y, ref_y=np.asarray(self.recon_yuv[0]))
        if mode4 is not None:
            xs = self._xs_with_modes(xs, data, sizes, mode4)
        org_y, org_cb, org_cr = self._upload(y, cb, cr)
        ref_y, ref_cb, ref_cr = (jnp.asarray(p, jnp.int32)
                                 for p in self._recon_dev)

        ry, rcb, rcr, coef_y, coef_cb, coef_cr, outs = \
            ss_scan.scan_encode_pss(
                org_y, org_cb, org_cr, ref_y, ref_cb, ref_cr,
                xs, zmaxw, zmax2n, sizes=sizes,
                qp=qp, qp_c=qp_c, bit_depth=cfg.bit_depth,
                strong=cfg.strong_intra_smoothing, w=w, h=h, radius=radius,
                radius_t=cfg.search_range_t, mi_size=cfg.mi_size,
                gt=cfg.gt, use_rdoq=cfg.rdoq, sbh=cfg.sbh,
                fixed_mode=mode4 is not None)

        maps = native.SliceMaps(w, h, cfg.ctb_log2, max_hier_depth=0)
        maps.slice_type = int(SliceType.PSS)
        maps.sbh = int(cfg.sbh)
        maps.mi_size = cfg.mi_size
        maps.num_ref = 2   # [temporal, SS(last)]
        cy_np, ccb_np, ccr_np, outs = self._fetch_all(
            coef_y, coef_cb, coef_cr, outs, h)
        maps.coef_y[:] = cy_np
        maps.coef_cb[:] = ccb_np
        maps.coef_cr[:] = ccr_np
        self._fill_maps(maps, sizes, scat, outs, pss=True)

        ry, rcb, rcr = ry[:h], rcb[:h // 2], rcr[:h // 2]
        if cfg.deblocking:
            ry, rcb, rcr = deblock.deblock_frame(
                ry, rcb, rcr, jnp.asarray(maps.tu4), qp=qp, qp_c=qp_c,
                bit_depth=cfg.bit_depth, pred4=maps.pred4,
                cbf4=maps.cbf4_y, ref4=maps.ref4, mv4x=maps.mv4x,
                mv4y=maps.mv4y)
        if cfg.sao:
            from hevc_hop_tpu.ops import sao as saop
            ry, rcb, rcr = saop.rdo_and_apply(
                (org_y[:h], org_cb[:h // 2], org_cr[:h // 2]),
                (ry, rcb, rcr), maps, cfg.ctb_log2,
                partition.full_lambda(qp), cfg.bit_depth)
        self._recon_dev = (ry, rcb, rcr)
        self._recon_np = None

        self.last_maps = maps
        sh = params.SliceHeader(slice_type=SliceType.PSS, slice_qp=qp,
                                idr=False, poc=poc,
                                num_ref_wire=maps.num_ref)
        hw = params.write_slice_header(sh, self.sps, self.pps)
        states = ctx_layout.init_states(int(SliceType.PSS), qp)
        payload = native.encode_slice_data_ss(states, maps)
        hw.write_bytes(payload)
        slice_nal = nal.make_nal(NalUnitType.TRAIL_R, hw.get_bytes())
        return nal.annexb_wrap([slice_nal, self._hash_sei()])

    @property
    def recon_yuv(self):
        if self._recon_np is None:
            udt = jnp.uint8 if self.cfg.bit_depth <= 8 else jnp.uint16
            got = jax.device_get(tuple(p.astype(udt)
                                       for p in self._recon_dev))
            self._recon_np = tuple(np.asarray(p, np.int32) for p in got)
        return self._recon_np

    def _hash_sei(self) -> bytes:
        from hevc_hop_tpu.bitstream import sei
        from hevc_hop_tpu.ops import hashes
        if self.cfg.hash_type == sei.HASH_CHECKSUM:
            digests = hashes.checksum_digests(*self._recon_dev,
                                              self.cfg.bit_depth)
        elif self.cfg.hash_type == sei.HASH_CRC:
            digests = hashes.crc_digests(*self.recon_yuv, self.cfg.bit_depth)
        else:
            digests = sei.plane_md5s(*self.recon_yuv, self.cfg.bit_depth)
        return nal.make_nal(
            NalUnitType.SUFFIX_SEI_NUT,
            sei.write_sei([sei.SEIMessage(
                sei.PICTURE_HASH,
                sei.make_picture_hash_payload(digests,
                                              self.cfg.hash_type))]))

    def recon_md5(self) -> bytes:
        y, cb, cr = self.recon_yuv
        return yuvio.picture_md5(y, cb, cr, self.cfg.bit_depth)
