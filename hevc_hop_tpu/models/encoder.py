"""All-intra HEVC encoder pipeline (round-1 scope: I slices, Main 8-bit).

Capability ref: TEncTop/TEncGOP/TEncSlice/TEncCu orchestration
(TEncGOP.cpp:338 compressGOP, TEncSlice.cpp:844 compressSlice,
TEncCu.cpp:371 xCompressCU). Batched tensor structure instead of CU
recursion:

  1. dense 35-mode SATD analysis at every CU size + quadtree DP
     partition/mode decision (models/partition.py) — batched XLA calls
  2. whole-frame wavefront recon (TU = CU) as ONE lax.scan program over
     topological levels, multi-size batches per step
     (models/wavefront_scan.py)
  3. dense maps -> native C++ slice-data serializer -> NAL/AnnexB
"""
from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from hevc_hop_tpu.bitstream import nal, params
from hevc_hop_tpu.common import rom
from hevc_hop_tpu.common.types import NalUnitType, SliceType
from hevc_hop_tpu.entropy import ctx_layout, native
from hevc_hop_tpu.io import yuv as yuvio
from hevc_hop_tpu.models import partition, wavefront, wavefront_scan
from hevc_hop_tpu.ops import deblock


@dataclasses.dataclass
class EncoderConfig:
    width: int = 64
    height: int = 64
    qp: int = 32
    bit_depth: int = 8
    ctb_log2: int = 5
    strong_intra_smoothing: bool = True
    deblocking: bool = True
    sao: bool = False
    # partition: None = quadtree DP (default); or fixed uniform CU log2
    cu_log2: int | None = None
    # mode decision: "analysis" (dense, original refs) or "rmd" (in-loop
    # SATD from recon refs)
    mode_decision: str = "analysis"
    # decoded-picture-hash SEI type: checksum is a device-side reduction
    # (no recon transfer); MD5 forces a full-frame fetch
    hash_type: int = 2  # sei.HASH_CHECKSUM
    # RDOQ level decisions (TComTrQuant.cpp:1489 xRateDistOptQuant analog)
    rdoq: bool = True
    # sign_data_hiding_enabled_flag (TComTrQuant.cpp:868 signBitHidingHDQ)
    sbh: bool = True
    # NxN intra at min CU (four 4x4 PUs/TUs, part_mode + intra_split;
    # TEncCu.cpp:1455 SIZE_NxN arm); analysis mode-decision only
    nxn: bool = True
    # residual quadtree: 16/32 CUs may keep one mode but split transforms
    # into half-size TUs (xEstimateResidualQT, TEncSearch.cpp:6824)
    rqt: bool = True
    # entropy_coding_sync_enabled_flag: one CABAC substream per CTU row,
    # coded by parallel host threads (TEncSlice.cpp:1158 WPP analog)
    wpp: bool = False


class IntraEncoder:
    def __init__(self, cfg: EncoderConfig) -> None:
        assert cfg.width % 2 == 0 and cfg.height % 2 == 0, \
            "4:2:0 needs even luma dimensions"
        # conformance window: code at the next multiple of MinCbSizeY and
        # signal the crop (TVideoIOYuv conformance-window handling /
        # SPS conf_win_*_offset, H.265 7.4.3.2)
        self.user_w, self.user_h = cfg.width, cfg.height
        pw, ph = -cfg.width % 8, -cfg.height % 8
        self._pad = (pw, ph)
        if pw or ph:
            cfg = dataclasses.replace(cfg, width=cfg.width + pw,
                                      height=cfg.height + ph)
        self.cfg = cfg
        if cfg.sao:
            assert cfg.width % (1 << cfg.ctb_log2) == 0 \
                and cfg.height % (1 << cfg.ctb_log2) == 0, \
                "SAO stats tiling needs CTU-aligned dims (pad input)"
        self._use_rqt = (cfg.rqt and cfg.cu_log2 is None
                         and cfg.mode_decision == "analysis")
        self.sps = params.SPS(
            pic_width=cfg.width, pic_height=cfg.height,
            bit_depth=cfg.bit_depth, ctb_log2=cfg.ctb_log2,
            max_transform_hierarchy_depth_intra=1 if self._use_rqt else 0,
            sao_enabled=cfg.sao,
            conf_win_right=self._pad[0], conf_win_bottom=self._pad[1],
            strong_intra_smoothing=cfg.strong_intra_smoothing)
        self.pps = params.PPS(init_qp=26,
                              sign_data_hiding=cfg.sbh,
                              entropy_coding_sync=cfg.wpp,
                              deblocking_disabled=not cfg.deblocking)

    def headers(self) -> list:
        vps = params.VPS()
        return [
            nal.make_nal(NalUnitType.VPS_NUT, params.write_vps(vps)),
            nal.make_nal(NalUnitType.SPS_NUT, params.write_sps(self.sps)),
            nal.make_nal(NalUnitType.PPS_NUT, params.write_pps(self.pps)),
        ]

    def _decide(self, y: np.ndarray):
        """Partition + shared-mode decision.
        Returns (depth8 [h/8,w/8] uint8 (3 = NxN), mode4 [h/4,w/4] int32
        or None)."""
        cfg = self.cfg
        w, h = cfg.width, cfg.height
        if cfg.cu_log2 is not None:
            depth8 = np.full((h // 8, w // 8),
                             cfg.ctb_log2 - cfg.cu_log2, np.uint8)
            return depth8, None, None  # in-loop RMD (TU = CU)
        if cfg.mode_decision == "rmd":
            return (np.full((h // 8, w // 8), cfg.ctb_log2 - 3, np.uint8),
                    None, None)
        # true-RD analysis at every CU size on a 32-aligned padded copy
        # (uint8/uint16 upload; rd_costs casts on device)
        pw, ph = -w % 32, -h % 32
        udt = np.uint8 if cfg.bit_depth <= 8 else np.uint16
        yp = np.pad(y.astype(udt), ((0, ph), (0, pw)), mode="edge")
        ypj = jnp.asarray(yp)
        rd8, m8 = partition.rd_costs(ypj, 8, cfg.qp, cfg.bit_depth)
        rd16, m16 = partition.rd_costs(ypj, 16, cfg.qp, cfg.bit_depth)
        rd32, m32 = partition.rd_costs(ypj, 32, cfg.qp, cfg.bit_depth)
        if self._use_rqt:
            rd4, m4 = partition.rd_costs(ypj, 4, cfg.qp, cfg.bit_depth)
            if not cfg.nxn:
                rd4 = rd4 + np.float32(1e18)   # NxN arm never wins
            up2 = lambda a: jnp.repeat(jnp.repeat(a, 2, 0), 2, 1)
            rd8f16 = partition.rd_costs_forced(ypj, up2(m16), 8, cfg.qp,
                                               cfg.bit_depth)
            rd16f32 = partition.rd_costs_forced(ypj, up2(m32), 16, cfg.qp,
                                                cfg.bit_depth)
            depth, mode4, tulog8 = partition.decide_rqt(
                rd4, rd8, rd16, rd32, rd8f16, rd16f32,
                m4, m8, m16, m32, cfg.qp, cfg.ctb_log2)
            depth, mode4, tulog8 = jax.device_get((depth, mode4, tulog8))
            return (depth[:h // 8, :w // 8].astype(np.uint8),
                    mode4[:h // 4, :w // 4].astype(np.int32),
                    tulog8[:h // 8, :w // 8].astype(np.uint8))
        if cfg.nxn:
            rd4, m4 = partition.rd_costs(ypj, 4, cfg.qp, cfg.bit_depth)
            depth, mode4 = partition.decide_nxn(
                rd4, rd8, rd16, rd32, m4, m8, m16, m32, cfg.qp,
                cfg.ctb_log2)
        else:
            depth, mode8 = partition.decide(rd8, rd16, rd32, m8, m16, m32,
                                            cfg.qp, cfg.ctb_log2)
            mode4 = jnp.repeat(jnp.repeat(mode8, 2, 0), 2, 1)
        depth, mode4 = jax.device_get((depth, mode4))  # one roundtrip
        return (depth[:h // 8, :w // 8].astype(np.uint8),
                mode4[:h // 4, :w // 4].astype(np.int32), None)

    def _schedule(self, depth8: np.ndarray, tulog8=None):
        """Schedule + scatter indices, cached per partition geometry.

        The wavefront schedule depends only on the leaf structure, so a
        repeated partition skips the host-side build (TEncSlice.cpp:1000's
        per-CTU walk has no equivalent cache because HM re-decides per CTU).
        tulog8: optional per-8x8-cell TU log2 (residual quadtree: a CU leaf
        whose tulog8 < its size splits into four z-order sub-TUs).
        """
        key = depth8.tobytes() + (tulog8.tobytes() if tulog8 is not None
                                  else b"")
        cache = getattr(self, "_sched_cache", None)
        if cache is None:
            import collections
            cache = self._sched_cache = collections.OrderedDict()
        if key in cache:
            cache.move_to_end(key)
            return cache[key]
        cfg = self.cfg
        w, h = cfg.width, cfg.height
        leaves = wavefront.leaves_from_depth(depth8, w, h, cfg.ctb_log2)
        if tulog8 is not None:
            tu_leaves = []
            for (x0, y0, lg) in leaves:
                tl = int(tulog8[y0 // 8, x0 // 8])
                if tl < lg:     # one RQT split level (max_hier_depth 1)
                    hfs = 1 << (lg - 1)
                    tu_leaves += [(x0, y0, lg - 1), (x0 + hfs, y0, lg - 1),
                                  (x0, y0 + hfs, lg - 1),
                                  (x0 + hfs, y0 + hfs, lg - 1)]
                else:
                    tu_leaves.append((x0, y0, lg))
            leaves = tu_leaves
        sizes, data, nsteps = wavefront_scan.build_schedule(
            leaves, w, h, cfg.ctb_log2)
        tu4 = np.zeros((h // 4, w // 4), np.uint8)
        for (x0, y0, log2) in leaves:
            tu4[y0 // 4:(y0 + (1 << log2)) // 4,
                x0 // 4:(x0 + (1 << log2)) // 4] = log2
        scat = {}
        for log2 in sizes:
            d = data[log2]
            vm = d["valid"].ravel()
            pxv = d["pos"][..., 0].ravel()[vm]
            pyv = d["pos"][..., 1].ravel()[vm]
            n = 1 << log2
            u = n // 4
            iy4 = pyv[:, None, None] // 4 + np.arange(u)[None, :, None]
            ix4 = pxv[:, None, None] // 4 + np.arange(u)[None, None, :]
            if log2 == 2:
                # chroma cbf lands at the CU (8x8) cell, carried by the
                # 4th PU of each NxN CU
                car = (pxv % 8 == 4) & (pyv % 8 == 4)
                iy8 = ((pyv[car] - 4) // 8)[:, None, None]
                ix8 = ((pxv[car] - 4) // 8)[:, None, None]
                scat[log2] = (vm, iy4, ix4, iy8, ix8, car)
            else:
                u = n // 8
                iy8 = pyv[:, None, None] // 8 + np.arange(u)[None, :, None]
                ix8 = pxv[:, None, None] // 8 + np.arange(u)[None, None, :]
                scat[log2] = (vm, iy4, ix4, iy8, ix8)
        val = (leaves, sizes, data, tu4, scat)
        cache[key] = val
        while len(cache) > 8:        # bounded (advisor round-4 pattern)
            cache.popitem(last=False)
        return val

    @staticmethod
    def _scatter_outputs(maps, sizes, scat, outs) -> None:
        for log2 in sizes:
            best, cbf_y, cbf_c = outs[log2]
            sc = scat[log2]
            vm, iy4, ix4, iy8, ix8 = sc[:5]
            nb = best.shape[1]
            mv = np.asarray(best).ravel()[vm][:, None, None]
            cyv = np.asarray(cbf_y).ravel()[vm][:, None, None]
            cbf_c = np.asarray(cbf_c).reshape(best.shape[0], 2, nb)
            cbv = cbf_c[:, 0].ravel()[vm]
            crv = cbf_c[:, 1].ravel()[vm]
            if log2 == 2:
                car = sc[5]
                cbv, crv = cbv[car], crv[car]
            maps.mode4[iy4, ix4] = mv
            maps.cbf4_y[iy4, ix4] = cyv
            maps.cbf8_cb[iy8, ix8] = cbv[:, None, None]
            maps.cbf8_cr[iy8, ix8] = crv[:, None, None]

    def encode_frame(self, y: np.ndarray, cb: np.ndarray,
                     cr: np.ndarray) -> bytes:
        """Encode one frame; returns the AnnexB byte stream (with headers).
        Reconstruction is kept on device; see recon_yuv / recon_md5.
        Per-stage wall-clock telemetry lands in self.last_stats
        (TEncGOP.cpp:1784 dEncTime analog)."""
        return self._stage2(self._stage1(y, cb, cr))

    def encode_frames(self, frames: list) -> list:
        """Pipelined multi-frame encode (throughput path): the device
        programs of frame i+1 are dispatched before frame i's results are
        fetched and entropy-coded on the host, so host work and
        device->host transfers overlap device compute
        (TEncGOP::compressGOP encodes a GOP strictly sequentially,
        TEncGOP.cpp:338 — here the seam between device and host work is
        the natural pipeline boundary).
        frames: [(y, cb, cr), ...] -> [stream, ...], bit-identical to
        per-frame encode_frame calls."""
        return list(self.iter_encode(frames))

    def iter_encode(self, frames):
        """Generator form of encode_frames: yields each frame's stream as
        soon as it is coded. Between two yields, recon_yuv / recon_md5 refer
        to the frame just yielded."""
        pend = None
        for (y, cb, cr) in frames:
            st = self._stage1(y, cb, cr)
            if pend is not None:
                yield self._stage2(pend)
            pend = st
        if pend is not None:
            yield self._stage2(pend)

    def _stage1(self, y, cb, cr) -> dict:
        """Decide + dispatch every device program for one frame; no
        device->host fetch beyond the (small) partition decision."""
        import time as _time
        stats = {}
        t0 = _time.perf_counter()
        cfg = self.cfg
        w, h = cfg.width, cfg.height
        pw, ph = self._pad
        if pw or ph:    # conformance-window edge padding
            y = np.pad(np.asarray(y), ((0, ph), (0, pw)), mode="edge")
            cb = np.pad(np.asarray(cb), ((0, ph // 2), (0, pw // 2)),
                        mode="edge")
            cr = np.pad(np.asarray(cr), ((0, ph // 2), (0, pw // 2)),
                        mode="edge")
        depth8, mode4, tulog8 = self._decide(y)
        leaves, sizes, data, tu4, scat = self._schedule(depth8, tulog8)
        stats["decide_s"] = _time.perf_counter() - t0

        maps = native.SliceMaps(
            w, h, cfg.ctb_log2,
            max_hier_depth=self.sps.max_transform_hierarchy_depth_intra)
        maps.sbh = int(cfg.sbh)
        # depth 3 = NxN: CU depth is min-CU, part_mode = NxN (part8 == 3)
        maps.depth8[:] = np.minimum(depth8, cfg.ctb_log2 - 3)
        maps.part8[:] = np.where(depth8 == cfg.ctb_log2 - 2, 3, 0)
        maps.tu4[:] = tu4

        xs = {}
        for log2 in sizes:
            d = data[log2]
            if mode4 is None:
                m = np.full(d["pos"].shape[:2], -1, np.int32)
            else:
                px = np.where(d["valid"], d["pos"][..., 0], 0)
                py = np.where(d["valid"], d["pos"][..., 1], 0)
                m = np.where(d["valid"], mode4[py // 4, px // 4],
                             0).astype(np.int32)
            xs[log2] = (jnp.asarray(d["pos"]), jnp.asarray(d["avail"]),
                        jnp.asarray(d["availc"]), jnp.asarray(m))
            if log2 == 2:
                # chroma DM mode for the CU carried by the 4th PU = the
                # PU0 luma mode (chroma_cand_list DM slot)
                px0 = (px // 8) * 8
                py0 = (py // 8) * 8
                cm = np.where(d["valid"], mode4[py0 // 4, px0 // 4],
                              0).astype(np.int32)
                xs[log2] = xs[log2] + (jnp.asarray(cm),)

        # uint8/uint16 upload (the device casts); pad rows are scratch
        pad = 1 << cfg.ctb_log2
        hc = h // 2
        hc_off = hc + pad
        udt = np.uint8 if cfg.bit_depth <= 8 else np.uint16
        org_y = np.zeros((h + pad, w), udt)
        org_y[:h] = y
        org_c = np.zeros((2 * hc_off, w // 2), udt)
        org_c[:hc] = cb
        org_c[hc_off:hc_off + hc] = cr

        qp = cfg.qp
        qp_c = rom.chroma_qp_from_luma(qp)
        t1 = _time.perf_counter()
        org_y_dev = jnp.asarray(org_y)
        org_c_dev = jnp.asarray(org_c)
        (ry, rc, coef_y, coef_c, coef8, wide,
         outs) = wavefront_scan.scan_encode(
            org_y_dev, org_c_dev, xs, sizes=sizes, qp=qp,
            qp_c=qp_c, bit_depth=cfg.bit_depth,
            strong=cfg.strong_intra_smoothing, h=h, hc_off=hc_off,
            use_rdoq=cfg.rdoq, init_type=int(SliceType.I),
            sbh=cfg.sbh, rmd=mode4 is None)
        stats["scan_s"] = _time.perf_counter() - t1

        t1 = _time.perf_counter()
        ry, rcb, rcr = ry[:h], rc[:hc], rc[hc_off:hc_off + hc]
        if cfg.deblocking:
            ry, rcb, rcr = deblock.deblock_frame(
                ry, rcb, rcr, jnp.asarray(maps.tu4), qp=qp, qp_c=qp_c,
                bit_depth=cfg.bit_depth)
        sao_stats = None
        if cfg.sao:
            from hevc_hop_tpu.ops import sao as saop
            # org references from the already-uploaded device planes
            oy = org_y_dev[:h]
            ocb = org_c_dev[:hc]
            ocr = org_c_dev[hc_off:hc_off + hc]
            sao_stats = saop.stats_dispatch((oy, ocb, ocr), (ry, rcb, rcr),
                                            cfg.ctb_log2, cfg.bit_depth)
        stats["loopfilter_s"] = _time.perf_counter() - t1
        stats["_t0"] = t0
        return dict(maps=maps, sizes=sizes, scat=scat, stats=stats,
                    recon=(ry, rcb, rcr), sao_stats=sao_stats,
                    wide=wide, coef8=coef8, coef16=(coef_y, coef_c),
                    outs=outs, hc=hc, hc_off=hc_off, qp=qp)

    def _stage2(self, st: dict) -> bytes:
        """Fetch + host RDO/entropy for a frame dispatched by _stage1."""
        import time as _time
        cfg = self.cfg
        maps, stats = st["maps"], st["stats"]
        hc, hc_off, qp = st["hc"], st["hc_off"], st["qp"]
        ry, rcb, rcr = st["recon"]

        # device->host: ONE batched fetch for the int8 coefficient planes,
        # the wide flag, the per-block entropy outputs, and (when on) the
        # SAO statistics — one roundtrip per frame instead of five
        t1 = _time.perf_counter()
        wide_np, c8y, c8c, outs_np, sao_np = jax.device_get(
            (st["wide"], st["coef8"][0], st["coef8"][1], st["outs"],
             st["sao_stats"]))
        if bool(wide_np):   # rare: some |level| > 127, refetch int16
            maps.coef_y[:], cc = jax.device_get(st["coef16"])
        else:
            maps.coef_y[:] = c8y.astype(np.int16)
            cc = c8c.astype(np.int16)
        maps.coef_cb[:] = cc[:hc]
        maps.coef_cr[:] = cc[hc_off:hc_off + hc]
        stats["fetch_s"] = _time.perf_counter() - t1

        t1 = _time.perf_counter()
        if sao_np is not None:
            from hevc_hop_tpu.models import partition as _part
            from hevc_hop_tpu.ops import sao as saop
            ry, rcb, rcr = saop.choose_apply(
                sao_np, (ry, rcb, rcr), maps, cfg.ctb_log2,
                _part.full_lambda(qp), cfg.bit_depth)
        self._recon_dev = (ry, rcb, rcr)
        self._recon_np = None
        stats["sao_s"] = _time.perf_counter() - t1

        # scatter per-block outputs into dense maps (host)
        t1 = _time.perf_counter()
        self._scatter_outputs(maps, st["sizes"], st["scat"], outs_np)
        stats["maps_s"] = _time.perf_counter() - t1

        # entropy: slice header + native slice data
        t1 = _time.perf_counter()
        sh = params.SliceHeader(slice_type=SliceType.I, slice_qp=qp)
        states = ctx_layout.init_states(int(SliceType.I), qp)
        if cfg.wpp:
            payload, subs = native.encode_slice_data_wpp(states, maps)
            # wire entry offsets = escaped byte counts per substream
            pos, wire = 0, []
            for s in subs[:-1]:
                wire.append(s + nal.ep_insert_count(payload[pos:pos + s]))
                pos += s
            sh.entry_offsets = wire
        else:
            payload = native.encode_slice_data(states, maps)
        hw = params.write_slice_header(sh, self.sps, self.pps)
        hw.write_bytes(payload)
        slice_nal = nal.make_nal(NalUnitType.IDR_W_RADL, hw.get_bytes())
        stats["entropy_s"] = _time.perf_counter() - t1
        # decoded-picture-hash SEI (TEncGOP.cpp:1789-1794)
        from hevc_hop_tpu.bitstream import sei
        from hevc_hop_tpu.ops import hashes
        if cfg.hash_type == sei.HASH_CHECKSUM:
            digests = hashes.checksum_digests(ry, rcb, rcr, cfg.bit_depth)
        elif cfg.hash_type == sei.HASH_CRC:
            digests = hashes.crc_digests(*self.recon_yuv, cfg.bit_depth)
        else:
            digests = sei.plane_md5s(*self.recon_yuv, cfg.bit_depth)
        sei_nal = nal.make_nal(
            NalUnitType.SUFFIX_SEI_NUT,
            sei.write_sei([sei.SEIMessage(
                sei.PICTURE_HASH,
                sei.make_picture_hash_payload(digests, cfg.hash_type))]))
        out = nal.annexb_wrap(self.headers() + [slice_nal, sei_nal])
        stats["total_s"] = _time.perf_counter() - stats.pop("_t0")
        stats["bytes"] = len(out)
        self.last_stats = stats
        return out

    @property
    def recon_full(self):
        """Full coded-size reconstruction (pre conformance crop) — the
        decoded-picture-hash domain."""
        if self._recon_np is None:
            udt = jnp.uint8 if self.cfg.bit_depth <= 8 else jnp.uint16
            got = jax.device_get(tuple(p.astype(udt)
                                       for p in self._recon_dev))
            self._recon_np = tuple(np.asarray(p, np.int32) for p in got)
        return self._recon_np

    @property
    def recon_yuv(self):
        y, cb, cr = self.recon_full
        uw, uh = self.user_w, self.user_h
        return (y[:uh, :uw], cb[:uh // 2, :uw // 2],
                cr[:uh // 2, :uw // 2])

    def recon_md5(self) -> bytes:
        y, cb, cr = self.recon_full
        return yuvio.picture_md5(y, cb, cr, self.cfg.bit_depth)
