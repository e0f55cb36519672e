"""HEVC decoder pipeline (round-1 scope: all-intra Main).

Capability ref: TDecTop.cpp:844 decode dispatch, TDecSlice/TDecCu recon.
Structure: native C++ parses the whole slice into dense maps; residuals are
dequantized + inverse-transformed densely (one batched XLA call per TU
size); prediction runs as a single lax.scan wavefront program when the CU
grid is uniform, falling back to per-step dispatch for mixed quadtrees.
"""
from __future__ import annotations

import collections
import functools

import numpy as np
import jax
import jax.numpy as jnp

from hevc_hop_tpu.bitstream import nal, params
from hevc_hop_tpu.common import rom
from hevc_hop_tpu.common.types import NalUnitType, SliceType
from hevc_hop_tpu.entropy import ctx_layout, native
from hevc_hop_tpu.io import yuv as yuvio
from hevc_hop_tpu.ops import quant, transform
from hevc_hop_tpu.models import wavefront, wavefront_scan
from hevc_hop_tpu.ops import deblock


@functools.partial(jax.jit, static_argnames=("qp", "bit_depth", "uni_log2",
                                             "dst4"))
def _residual_uniform(coefp, qp: int, bit_depth: int, uni_log2: int,
                      dst4: bool = False):
    n = 1 << uni_log2
    h, w = coefp.shape
    blocks = coefp.astype(jnp.int32).reshape(
        h // n, n, w // n, n).transpose(0, 2, 1, 3).reshape(-1, n, n)
    deq = quant.dequant(blocks, qp, uni_log2, bit_depth)
    resi = transform.inv_transform(deq, bit_depth,
                                   use_dst=dst4 and uni_log2 == 2)
    return resi.reshape(h // n, w // n, n, n).transpose(
        0, 2, 1, 3).reshape(h, w)


@functools.partial(jax.jit, static_argnames=("qp", "bit_depth", "sizes",
                                             "dst4"))
def _residual_mixed(coefp, pos_by_size, qp: int, bit_depth: int,
                    sizes: tuple, dst4: bool = False):
    out = jnp.zeros(coefp.shape, jnp.int32)
    coefp = coefp.astype(jnp.int32)
    for log2 in sizes:
        n = 1 << log2
        pos = pos_by_size[log2]          # [K, 2] int32 (x, y)
        rows = pos[:, 1:2, None] + jnp.arange(n)[None, :, None]
        cols = pos[:, 0:1, None].transpose(0, 2, 1) \
            + jnp.arange(n)[None, None, :]
        rows = jnp.broadcast_to(rows, (pos.shape[0], n, n))
        cols = jnp.broadcast_to(cols, (pos.shape[0], n, n))
        blocks = coefp[rows, cols]
        deq = quant.dequant(blocks, qp, log2, bit_depth)
        resi = transform.inv_transform(deq, bit_depth,
                                       use_dst=dst4 and log2 == 2)
        out = out.at[rows, cols].set(resi)
    return out


def _dense_residual(coef_plane: np.ndarray, leaves, qp: int, bit_depth: int,
                    chroma: bool, dst4: bool = False) -> jnp.ndarray:
    """Dequant + inverse transform all TUs, batched per size.

    Returns a DEVICE plane — the decode pipeline stays on device end to
    end; only final pictures are (lazily) fetched."""
    sizes = {log2 for (_, _, log2) in leaves}
    # int8 upload fast path halves the host->device coefficient traffic
    cp = (coef_plane.astype(np.int8)
          if np.abs(coef_plane, dtype=np.int32).max(initial=0) <= 127
          else coef_plane)
    dst4 = dst4 and not chroma   # DST: 4x4 intra LUMA only (8.6.4.2)
    if len(sizes) == 1:
        log2 = next(iter(sizes)) - (1 if chroma else 0)
        return _residual_uniform(jnp.asarray(cp), qp, bit_depth, log2,
                                 dst4)
    by_size = {}
    for (x, y, log2) in leaves:
        if chroma:
            x, y, log2 = x // 2, y // 2, log2 - 1
        by_size.setdefault(log2, []).append((x, y))
    pos = {log2: jnp.asarray(np.array(p, np.int32))
           for log2, p in sorted(by_size.items())}
    return _residual_mixed(jnp.asarray(cp), pos, qp, bit_depth,
                           tuple(sorted(by_size)), dst4)


class Decoder:
    # schedule construction is pure in (geometry, mv rects); cache across
    # frames/streams so repeated partitions skip the host-side build
    _sched_cache: collections.OrderedDict = collections.OrderedDict()
    _SCHED_CACHE_MAX = 8

    def __init__(self) -> None:
        self.sps = None
        self.pps = None
        self.vps = None
        self._pics_dev = []   # device (y, cb, cr) int32 triples
        self._pics_np = []    # lazily fetched host copies
        self.hash_ok = []   # per decoded-picture-hash SEI verification
        self.concealed = []  # indices of synthesized lost references
        self.sei_log = []    # (payload_type, parsed-or-raw) observability

    @property
    def pictures_full(self) -> list:
        """Host (numpy int32) decoded pictures at CODED size (the
        decoded-picture-hash domain), fetched lazily in one batched
        roundtrip (uint8/uint16 over the wire)."""
        if len(self._pics_np) < len(self._pics_dev):
            udt = (jnp.uint8 if self.sps.bit_depth <= 8 else jnp.uint16)
            pend = self._pics_dev[len(self._pics_np):]
            got = jax.device_get([tuple(p.astype(udt) for p in t)
                                  for t in pend])
            self._pics_np.extend(
                tuple(np.asarray(p, np.int32) for p in t) for t in got)
        return self._pics_np

    @property
    def pictures(self) -> list:
        """Output pictures with the SPS conformance window applied
        (TVideoIOYuv conformance-window crop analog)."""
        full = self.pictures_full
        cr_, cb_ = self.sps.conf_win_right, self.sps.conf_win_bottom
        if not (cr_ or cb_):
            return full
        uw = self.sps.pic_width - cr_
        uh = self.sps.pic_height - cb_
        return [(y[:uh, :uw], cb[:uh // 2, :uw // 2],
                 cr[:uh // 2, :uw // 2]) for (y, cb, cr) in full]

    def decode_stream(self, stream: bytes) -> list:
        """Decode an AnnexB stream; returns list of (y, cb, cr) frames."""
        from hevc_hop_tpu.bitstream import sei as seimod
        from hevc_hop_tpu.ops import hashes
        for (nal_type, rbsp) in nal.annexb_split(stream):
            if nal_type == NalUnitType.VPS_NUT:
                self.vps = params.parse_vps(rbsp)
            elif nal_type == NalUnitType.SPS_NUT:
                self.sps = params.parse_sps(rbsp)
            elif nal_type == NalUnitType.PPS_NUT:
                self.pps = params.parse_pps(rbsp)
            elif nal_type in (NalUnitType.IDR_W_RADL, NalUnitType.IDR_N_LP,
                              NalUnitType.CRA_NUT, NalUnitType.TRAIL_R):
                self._decode_slice(rbsp, nal_type)
            elif nal_type in (NalUnitType.PREFIX_SEI_NUT,
                              NalUnitType.SUFFIX_SEI_NUT):
                for msg in seimod.parse_sei(rbsp):
                    if msg.payload_type == seimod.RECOVERY_POINT:
                        self.sei_log.append(
                            ("recovery_point",
                             seimod.parse_recovery_point(msg.payload)))
                    elif msg.payload_type == seimod.ACTIVE_PARAMETER_SETS:
                        self.sei_log.append(
                            ("active_parameter_sets",
                             seimod.parse_active_parameter_sets(
                                 msg.payload)))
                    elif msg.payload_type == seimod.USER_DATA_UNREGISTERED:
                        self.sei_log.append(
                            ("user_data",
                             seimod.parse_user_data_unregistered(
                                 msg.payload)))
                    if (msg.payload_type == seimod.PICTURE_HASH
                            and self._pics_dev):
                        # TDecGop.cpp:230 calcAndPrintHashStatus; the
                        # checksum type verifies as a device reduction
                        # (no picture transfer)
                        if msg.payload[0] == seimod.HASH_CHECKSUM:
                            dig = hashes.checksum_digests(
                                *self._pics_dev[-1], self.sps.bit_depth)
                            self.hash_ok.append(
                                msg.payload[1:] == b"".join(dig))
                        else:
                            self.hash_ok.append(seimod.verify_picture_hash(
                                msg.payload, *self.pictures_full[-1],
                                self.sps.bit_depth))
        return self.pictures

    def _decode_slice(self, rbsp: bytes, nal_type: int) -> None:
        sps, pps = self.sps, self.pps
        holo = bool(self.vps and self.vps.holo)
        sh = params.parse_slice_header(rbsp, sps, pps, nal_type, holo)
        assert sh.slice_type in (SliceType.I, SliceType.ISS,
                                 SliceType.PSS), "P/B slices TODO"
        w, h, bd = sps.pic_width, sps.pic_height, sps.bit_depth
        qp = sh.slice_qp
        states = ctx_layout.init_states(int(sh.slice_type), qp)
        if sh.slice_type == SliceType.PSS:
            # the signaled L0 count INCLUDES the virtual SS ref, which
            # replaces the LAST entry (TComSlice.cpp:497-506)
            num_ref = sh.num_ref_wire
            maps = native.decode_slice_data_ss(
                states, rbsp[sh.data_offset:], w, h, sps.ctb_log2,
                sps.max_transform_hierarchy_depth_intra,
                int(SliceType.PSS), self.vps.holo_mi_size, num_ref,
                sao_on=int(sps.sao_enabled),
                sbh=int(pps.sign_data_hiding))
        elif sh.slice_type == SliceType.ISS:
            maps = native.decode_slice_data_ss(
                states, rbsp[sh.data_offset:], w, h, sps.ctb_log2,
                sps.max_transform_hierarchy_depth_intra,
                int(SliceType.ISS), self.vps.holo_mi_size,
                sao_on=int(sps.sao_enabled),
                sbh=int(pps.sign_data_hiding))
        elif pps.entropy_coding_sync:
            # WPP: wire entry offsets -> RBSP substream sizes -> parallel
            # row decode (TDecSlice.cpp:262,371 context-sync analog)
            data = rbsp[sh.data_offset:]
            ny = (h + (1 << sps.ctb_log2) - 1) >> sps.ctb_log2
            assert len(sh.entry_offsets) == ny - 1, "entry point count"
            subs = nal.unwire_substream_sizes(data, sh.entry_offsets)
            maps = native.decode_slice_data_wpp(
                states, data, subs, w, h, sps.ctb_log2,
                max_hier_depth=sps.max_transform_hierarchy_depth_intra,
                sao_on=int(sps.sao_enabled),
                sbh=int(pps.sign_data_hiding))
        else:
            maps = native.decode_slice_data(
                states, rbsp[sh.data_offset:], w, h, sps.ctb_log2,
                max_hier_depth=sps.max_transform_hierarchy_depth_intra,
                sao_on=int(sps.sao_enabled),
                sbh=int(pps.sign_data_hiding))

        self.last_maps = maps   # parsed syntax, for inspection
        # reconstruction structure = TRANSFORM blocks (prediction is per-TU)
        leaves = wavefront.tu_blocks_from_maps(maps.depth8, maps.tu4,
                                               w, h, sps.ctb_log2)
        qp_c = rom.chroma_qp_from_luma(qp)
        intra_dst4 = sh.slice_type in (SliceType.I, SliceType.ISS)
        resi_y = _dense_residual(maps.coef_y, leaves, qp, bd, False,
                                 dst4=intra_dst4)
        # chroma TUs follow the CU tree only down to 8x8 luma: an NxN CU's
        # chroma is ONE 4x4 TU at the CU origin, not four 2x2s
        cu_leaves = ([lv for lv in leaves if lv[2] >= 3]
                     + sorted({((x // 8) * 8, (y // 8) * 8, 3)
                               for (x, y, lg) in leaves if lg == 2}))
        resi_cb = _dense_residual(maps.coef_cb, cu_leaves, qp_c, bd, True)
        resi_cr = _dense_residual(maps.coef_cr, cu_leaves, qp_c, bd, True)
        self._cur_qp = qp
        if sh.slice_type in (SliceType.ISS, SliceType.PSS):
            self._recon_ss(maps, leaves, resi_y, resi_cb, resi_cr)
        else:
            self._recon(maps, leaves, resi_y, resi_cb, resi_cr)

    @classmethod
    def _cached_schedule(cls, key, build):
        hit = cls._sched_cache.get(key)
        if hit is not None:
            cls._sched_cache.move_to_end(key)
            return hit
        val = build()
        cls._sched_cache[key] = val
        while len(cls._sched_cache) > cls._SCHED_CACHE_MAX:
            cls._sched_cache.popitem(last=False)
        return val

    def _recon(self, maps, leaves, resi_y, resi_cb, resi_cr) -> None:
        sps = self.sps
        w, h, bd = sps.pic_width, sps.pic_height, sps.bit_depth
        key = ("i", w, h, sps.ctb_log2, np.array(leaves, np.int32).tobytes())
        sizes, data, nsteps = self._cached_schedule(
            key, lambda: wavefront_scan.build_schedule(
                leaves, w, h, sps.ctb_log2))
        xs = {}
        for log2 in sizes:
            d = data[log2]
            pos, valid = d["pos"], d["valid"]
            px = np.where(valid, pos[..., 0], 0)
            py = np.where(valid, pos[..., 1], 0)
            modes = maps.mode4[py // 4, px // 4].astype(np.int32)
            cm = maps.cmode8[py // 8, px // 8].astype(np.int32)
            if log2 == 2:
                # chroma DM of an NxN CU follows PU0's luma mode
                pu0 = maps.mode4[((py // 8) * 8) // 4,
                                 ((px // 8) * 8) // 4].astype(np.int32)
                cmodes = np.where(cm == 36, pu0, cm)
            else:
                cmodes = np.where(cm == 36, modes, cm)
            modes = np.where(valid, modes, 0)
            cmodes = np.where(valid, cmodes, 0)
            xs[log2] = (jnp.asarray(pos), jnp.asarray(d["avail"]),
                        jnp.asarray(d["availc"]), jnp.asarray(modes),
                        jnp.asarray(cmodes))

        pad = 1 << sps.ctb_log2
        rpy = jnp.zeros((h + pad, w), jnp.int32).at[:h].set(resi_y)
        rpcb = jnp.zeros((h // 2 + pad, w // 2), jnp.int32).at[:h // 2].set(
            resi_cb)
        rpcr = jnp.zeros((h // 2 + pad, w // 2), jnp.int32).at[:h // 2].set(
            resi_cr)
        ry, rcb, rcr = wavefront_scan.scan_decode(
            rpy, rpcb, rpcr, xs, sizes=sizes, bit_depth=bd,
            strong=sps.strong_intra_smoothing, h=h)
        ry, rcb, rcr = ry[:h], rcb[:h // 2], rcr[:h // 2]
        if not self.pps.deblocking_disabled:
            from hevc_hop_tpu.common import rom as _rom
            qp_c = _rom.chroma_qp_from_luma(self._cur_qp)
            ry, rcb, rcr = deblock.deblock_frame(
                ry, rcb, rcr, jnp.asarray(maps.tu4), qp=self._cur_qp,
                qp_c=qp_c, bit_depth=bd,
                beta_off=self.pps.beta_offset_div2,
                tc_off=self.pps.tc_offset_div2)
        if self.sps.sao_enabled:
            from hevc_hop_tpu.ops import sao as saop
            ry, rcb, rcr = saop.apply_sao_frame(
                ry, rcb, rcr, maps.sao_type, maps.sao_off, maps.sao_band,
                self.sps.ctb_log2, bd)
        self._pics_dev.append((ry, rcb, rcr))

    def _recon_ss(self, maps, leaves, resi_y, resi_cb, resi_cr) -> None:
        """ISS reconstruction: MV-aware wavefront over intra + SS CUs.

        Mirror of TDecCu.cpp:454-476 (recon feeding the SS ref) — the
        schedule is built from the ACTUAL coded MV dependency rects, so
        independent CUs batch together regardless of z distance.
        """
        from hevc_hop_tpu.models import ss_scan
        sps = self.sps
        w, h, bd = sps.pic_width, sps.pic_height, sps.bit_depth

        pss = maps.slice_type == int(SliceType.PSS)
        ss_idx = maps.num_ref - 1
        arr = np.array(leaves, np.int32)
        lx, ly, lg = arr[:, 0], arr[:, 1], arr[:, 2]
        n = (1 << lg).astype(np.int32)
        x4, y4 = lx // 4, ly // 4
        is_ss = ((maps.pred4[y4, x4] == 0)
                 & (maps.ref4[y4, x4] == ss_idx))   # SS PUs
        mvx = maps.mv4x[y4, x4].astype(np.int32) >> 2
        mvy = maps.mv4y[y4, x4].astype(np.int32) >> 2
        gt = maps.gt8[ly // 8, lx // 8] != 0
        # GT warp reads the clamped 2n window (+chroma slack); plain MC
        # reads the n window + interpolation margin
        f = np.where(gt, 2, ss_scan.IFM)
        x0 = np.where(gt, lx + mvx - n // 2 - f, lx + mvx - f)
        y0 = np.where(gt, ly + mvy - n // 2 - f, ly + mvy - f)
        wh = np.where(gt, 2 * n + 2 * f, n + 2 * f)
        rects = np.where(is_ss[:, None],
                         np.stack([x0, y0, wh, wh], -1), 0).astype(np.int32)
        key = ("ss", w, h, sps.ctb_log2,
               np.array(leaves, np.int32).tobytes(), rects.tobytes())
        sizes, data, nsteps = self._cached_schedule(
            key, lambda: ss_scan.build_schedule_ss(
                leaves, w, h, sps.ctb_log2, radius=0, mv_rect=rects))

        xs = {}
        for log2 in sizes:
            d = data[log2]
            pos, valid = d["pos"], d["valid"]
            px = np.where(valid, pos[..., 0], 0)
            py = np.where(valid, pos[..., 1], 0)
            modes = maps.mode4[py // 4, px // 4].astype(np.int32)
            cm = maps.cmode8[py // 8, px // 8].astype(np.int32)
            cmodes = np.where(cm == 36, modes, cm)
            inter = np.where(valid, maps.pred4[py // 4, px // 4] == 0,
                             False).astype(np.int32)
            ssf = inter * (maps.ref4[py // 4, px // 4] == ss_idx)
            tf = inter * (1 - (maps.ref4[py // 4, px // 4] == ss_idx))
            mvq = np.stack([maps.mv4x[py // 4, px // 4],
                            maps.mv4y[py // 4, px // 4]], -1).astype(np.int32)
            mvq = np.where(inter[..., None] != 0, mvq, 0)
            gtf = np.where(valid, maps.gt8[py // 8, px // 8],
                           0).astype(np.int32)
            gtv = maps.gtv8[py // 8, px // 8].astype(np.int32)
            gtv = np.where(gtf[..., None] != 0, gtv, 0)
            common = (jnp.asarray(pos), jnp.asarray(d["avail"]),
                      jnp.asarray(d["availc"]),
                      jnp.asarray(np.where(valid, modes, 0)),
                      jnp.asarray(np.where(valid, cmodes, 0)))
            if pss:
                xs[log2] = common + (jnp.asarray(ssf.astype(np.int32)),
                                     jnp.asarray(tf.astype(np.int32)),
                                     jnp.asarray(mvq), jnp.asarray(gtf),
                                     jnp.asarray(gtv))
            else:
                xs[log2] = common + (jnp.asarray(inter), jnp.asarray(mvq),
                                     jnp.asarray(gtf), jnp.asarray(gtv))

        pad = 1 << sps.ctb_log2
        rpy = jnp.zeros((h + pad, w), jnp.int32).at[:h].set(resi_y)
        rpcb = jnp.zeros((h // 2 + pad, w // 2), jnp.int32).at[:h // 2].set(
            resi_cb)
        rpcr = jnp.zeros((h // 2 + pad, w // 2), jnp.int32).at[:h // 2].set(
            resi_cr)
        if pss:
            if not self._pics_dev:
                # lost-reference concealment (TDecTop.cpp:258
                # xCreateLostPicture analog): synthesize a mid-grey
                # reference and keep decoding; the event is recorded so
                # callers can flag the corrupted output
                mid = 1 << (bd - 1)
                self._pics_dev.append(
                    (jnp.full((h, w), mid, jnp.int32),
                     jnp.full((h // 2, w // 2), mid, jnp.int32),
                     jnp.full((h // 2, w // 2), mid, jnp.int32)))
                self._pics_np.append(tuple(
                    np.full(p.shape, mid, np.int32)
                    for p in self._pics_dev[-1]))
                self.concealed.append(len(self._pics_dev) - 1)
            py_, pcb, pcr = self._pics_dev[-1]
            ry, rcb, rcr = ss_scan.scan_decode_pss(
                rpy, rpcb, rpcr, py_, pcb, pcr, xs, sizes=sizes,
                bit_depth=bd, strong=sps.strong_intra_smoothing, h=h)
        else:
            ry, rcb, rcr = ss_scan.scan_decode_ss(
                rpy, rpcb, rpcr, xs, sizes=sizes, bit_depth=bd,
                strong=sps.strong_intra_smoothing, h=h)
        ry, rcb, rcr = ry[:h], rcb[:h // 2], rcr[:h // 2]
        if not self.pps.deblocking_disabled:
            qp_c = rom.chroma_qp_from_luma(self._cur_qp)
            ry, rcb, rcr = deblock.deblock_frame(
                ry, rcb, rcr, jnp.asarray(maps.tu4), qp=self._cur_qp,
                qp_c=qp_c, bit_depth=bd,
                beta_off=self.pps.beta_offset_div2,
                tc_off=self.pps.tc_offset_div2, pred4=maps.pred4,
                cbf4=maps.cbf4_y, ref4=maps.ref4, mv4x=maps.mv4x,
                mv4y=maps.mv4y)
        if self.sps.sao_enabled:
            from hevc_hop_tpu.ops import sao as saop
            ry, rcb, rcr = saop.apply_sao_frame(
                ry, rcb, rcr, maps.sao_type, maps.sao_off, maps.sao_band,
                self.sps.ctb_log2, bd)
        self._pics_dev.append((ry, rcb, rcr))

    def picture_md5(self, idx: int = -1) -> bytes:
        # the decoded-picture hash covers the FULL coded picture
        y, cb, cr = self.pictures_full[idx]
        return yuvio.picture_md5(y, cb, cr, self.sps.bit_depth)
