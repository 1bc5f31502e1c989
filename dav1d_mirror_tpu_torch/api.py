"""Public decoder API (the analogue of dav1d's 3-function hot API).

Port of ``dav1d_mirror_tpu/api.py``. A `Decoder` is opened with
`Settings`, fed temporal units with `send_data`, and produces `Picture`s
from `get_picture`; `flush` resets in-flight state for seeking. By default
every frame takes the hybrid device route: native entropy decode on the
host, the frame's pixel program on the device (models/inter), the intra
blocks in the native host walk, then deblock, CDEF, super-resolution and
loop restoration on the device (models/filters). With
``Settings.intra_engine`` the device intra engine (models/intra)
reconstructs the intra blocks instead: a frame whose blocks are all intra
runs the engine's own program, and an inter frame whose only host work
would be plain intra blocks runs it inside its pixel program, so neither
downloads its planes before the filters. A super-res frame is
reconstructed at its coded width and leaves the filter chain upscaled;
references, outputs and grain see the upscaled planes. With
``Settings.apply_grain`` (the default) a frame that carries film grain is
grained on the device on its way out (ops/filmgrain); the reference
planes stay grain-free. ``Decoder.apply_grain`` grains a decoded picture
on its own (dav1d_apply_grain).

With ``n_threads`` > 1 or ``max_frame_delay`` > 1 the decode is pipelined
in four in-order stages, as the reference's is (dav1d frame threading
re-expressed as host entropy(N+1) || device pixels(N)): entropy and every
reference-state update on the caller thread; program building on one
worker, or two when ``n_threads`` >= 2; the pixel program and the filter
chain on one worker, on its current CUDA stream; and the download of the
output planes on one worker, which copies them into pinned host memory on
a side stream. A picture is ready once its download has finished, and an
error of the pixel stage surfaces at ``get_picture`` (or at a later
``send_obus`` that waits for that frame), as in the reference. The output
order, the frame count and every byte equal those of the in-order decode.

The device is `Settings.device` ("cuda" by default). Asking for CUDA
where PyTorch has none raises; nothing falls back to the CPU.

Reference parity: dav1d_open src/lib.c:138, dav1d_send_data :437,
dav1d_get_picture :457, dav1d_flush :525, dav1d_apply_grain
include/dav1d/dav1d.h:235, dav1d_get_event_flags :268-295, show-existing
handling
src/obu.c:1572-1682, inloop-filter debug mask include/dav1d/dav1d.h:66-74.
"""
from __future__ import annotations

import concurrent.futures as _cf
from dataclasses import dataclass, replace

import numpy as np
import torch

from .data.tables import new_cdf_context, qcat_from_qidx, cdf_thread_update
from .errors import DecodeError
from .host import headers as h
from .host import native_tile
from .host import obu as obu_mod
from .host.ivf import split_obus
from .host.native import NativeMsac
from .host.tilecoder import TileCoder, DecodeSide
from .models.filters import apply_inloop_filters, download_planes
from .models.frame_buffers import FrameBuffers, _tile_payload
from .models.frame_exec import plane_to_torch
from .models.inter import build_frame_program, execute_frame_program
from .models.intra import build_intra_frame, run_intra_frame
from .models.plan_vec import all_intra
from .ops.filmgrain import apply_film_grain
from .utils import stages

INLOOPFILTER_NONE = 0
INLOOPFILTER_DEBLOCK = 1
INLOOPFILTER_CDEF = 2
INLOOPFILTER_RESTORATION = 4
INLOOPFILTER_ALL = 7

# Dav1dDecodeFrameType (include/dav1d/dav1d.h:71-76)
DECODEFRAMETYPE_ALL = 0
DECODEFRAMETYPE_REFERENCE = 1
DECODEFRAMETYPE_INTRA = 2
DECODEFRAMETYPE_KEY = 3

# Dav1dEventFlags (include/dav1d/dav1d.h:268-295)
EVENT_FLAG_NEW_SEQUENCE = 1
EVENT_FLAG_NEW_OP_PARAMS_INFO = 2


@dataclass
class Settings:
    """Analogue of Dav1dSettings (include/dav1d/dav1d.h:78-99)."""
    # either > 1 pipelines the decode (entropy || build || pixels ||
    # download); n_threads >= 2 gives program building two workers, and
    # max_frame_delay bounds the frames in flight (at least 2)
    n_threads: int = 0
    max_frame_delay: int = 0
    apply_grain: bool = True
    operating_point: int = 0
    all_layers: bool = True
    frame_size_limit: int = 0
    strict_std_compliance: bool = False
    output_invisible_frames: bool = False
    inloop_filters: int = INLOOPFILTER_ALL
    decode_frame_type: int = DECODEFRAMETYPE_ALL
    # Dav1dLogger analogue (dav1d.h:49-59): callable(str) or None for
    # the default stderr logger; False-y disables logging entirely
    logger: object = "default"
    # torch device of the pixel stage
    device: str = "cuda"
    # the device intra engine (models/intra) for the intra blocks; the
    # reference's use_tpu_intra_engine. None (auto) and False take the
    # hybrid route (intra blocks in the native host walk)
    intra_engine: bool | None = None


@dataclass
class Picture:
    """Analogue of Dav1dPicture (decoded planes + stream metadata)."""
    planes: tuple
    width: int = 0
    height: int = 0
    bitdepth: int = 8
    layout: int = h.PIXEL_LAYOUT_I420
    frame_hdr: object = None
    seq_hdr: object = None
    # HDR metadata props (Dav1dPicture content_light/mastering_display/
    # itut_t35, picture.h:52-63)
    content_light: tuple = None
    mastering_display: dict = None
    itut_t35: tuple = ()
    # first picture of a temporal unit (PICTURE_FLAG_NEW_TEMPORAL_UNIT)
    new_temporal_unit: bool = False


def get_frame_delay(settings: Settings | None = None) -> int:
    """dav1d_get_frame_delay (include/dav1d/dav1d.h:323): how many
    frames a decoder opened with these settings may buffer internally
    before get_picture returns the first one."""
    s = settings or Settings()
    if s.max_frame_delay < 0 or s.max_frame_delay > 256 or \
            s.n_threads < 0 or s.n_threads > 256:
        raise ValueError("invalid settings")
    if s.n_threads > 1 or s.max_frame_delay > 1:
        return max(s.max_frame_delay, 2)
    return 1


def parse_sequence_header(data: bytes) -> h.SequenceHeader:
    """dav1d_parse_sequence_header: scan OBUs for a sequence header."""
    st = obu_mod.ObuState()
    for _, obu_data in split_obus(data):
        try:
            obu_mod.parse_obus(st, obu_data)
        except obu_mod.ParseError:
            continue
        if st.seq_hdr is not None:
            return st.seq_hdr
    raise DecodeError("no sequence header")


def _check_refs(fhdr, coders, refs):
    """Raise as the reference's pixel stage does (ref_decoder.py:351)
    when an inter block predicts from an empty reference slot: a slot no
    frame has filled, e.g. after the keyframe failed to decode."""
    if fhdr.frame_type in (h.KEY, h.INTRA) or all(
            refs[fhdr.refidx[i]] is not None for i in range(7)):
        return
    for coder in coders:
        for b in coder.blocks:
            if b.intra:
                continue
            for ri in (b.ref[0], b.ref[1] if b.comp_type else -1):
                if ri >= 0 and refs[fhdr.refidx[ri]] is None:
                    raise DecodeError("missing reference frame")


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda is not available")
    return dev


class Decoder:
    """dav1d_open/send_data/get_picture/flush/close as one object."""

    def __init__(self, settings: Settings | None = None):
        self.s = settings or Settings()
        if self.s.frame_size_limit and self.s.frame_size_limit < 0:
            raise ValueError("invalid frame_size_limit")
        get_frame_delay(self.s)     # validates n_threads, max_frame_delay
        self.device = resolve_device(self.s.device)
        if not native_tile.available():
            raise RuntimeError("native tile walk unavailable")
        # the pipeline (reference api.py:229-258): an in-order pixel
        # worker, 1-2 program builders, an in-order download worker.
        # Entropy and every reference-state update stay on the caller
        # thread (they depend on entropy only).
        self._pipe = self._build_pipe = self._gather_pipe = None
        self._inflight = []
        self._ginflight = []
        self._dl_stream = None
        if self.s.n_threads > 1 or self.s.max_frame_delay > 1:
            self._pipe = _cf.ThreadPoolExecutor(
                1, thread_name_prefix="dav1d-pixels")
            self._build_pipe = _cf.ThreadPoolExecutor(
                2 if self.s.n_threads >= 2 else 1,
                thread_name_prefix="dav1d-build")
            self._gather_pipe = _cf.ThreadPoolExecutor(
                1, thread_name_prefix="dav1d-download")
            self._frame_delay = max(self.s.max_frame_delay, 2)
            if self.device.type == "cuda":
                self._dl_stream = torch.cuda.Stream(self.device)
        self.flush()

    # -- lifecycle ---------------------------------------------------------
    def _drain_pipe(self):
        """Wait out every frame in flight. Their errors were already
        reported, or are dropped with the frames (flush/close), as the
        reference's _drain_pipe drops them."""
        for futs in (self._inflight, self._ginflight):
            for f in futs:
                try:
                    f.result()
                except Exception:
                    pass
            futs.clear()

    def flush(self):
        """dav1d_flush: drop in-flight state, keep the sequence header."""
        self._drain_pipe()
        seq = getattr(self, "_st", None) and self._st.seq_hdr
        self._st = obu_mod.ObuState()
        self._st.seq_hdr = seq
        self._st.operating_point = self.s.operating_point
        self._refs = [None] * 8       # FrameBuffers (post-filter planes)
        self._ref_cdfs = [None] * 8
        self._ref_tmvs = [None] * 8
        self._ref_refpoc = [[0] * 7 for _ in range(8)]
        self._ref_segmaps = [None] * 8
        self._out = []                # decoded Picture queue
        self._sl_cache = None         # spatial-layer candidate (lib.c:331)
        self._errored_slots = set()   # refs poisoned by decode errors
        self._event_flags = 0
        self.last_error = None        # dav1d_get_decode_error_data_props

    def close(self):
        self._drain_pipe()
        for pool in (self._pipe, self._build_pipe, self._gather_pipe):
            if pool is not None:
                pool.shutdown(wait=True)
        self._pipe = self._build_pipe = self._gather_pipe = None
        self._out = []
        self._refs = [None] * 8

    def get_event_flags(self) -> int:
        """dav1d_get_event_flags: returns and clears accumulated flags."""
        f = self._event_flags
        self._event_flags = 0
        return f

    def _log(self, msg: str):
        lg = self.s.logger
        if lg == "default":
            import sys
            print(f"dav1d_mirror_tpu_torch: {msg}", file=sys.stderr)
        elif callable(lg):
            lg(msg)

    # -- input -------------------------------------------------------------
    def send_data(self, data: bytes):
        """Feed one temporal unit (a sequence of length-prefixed OBUs).
        Decodes any frame completed by this data."""
        self.send_obus(o for _, o in split_obus(data))

    def send_obus(self, obus):
        """Feed individual complete OBUs (with or without size fields).

        Errors are CONTAINED (dav1d abort_frame): a frame that fails to
        parse or decode, for whatever reason, poisons the reference slots
        it would have refreshed and raises DecodeError, but the decoder
        object stays consistent: feeding the next keyframe (or calling
        flush()) resumes normal operation."""
        prev_seq = self._st.seq_hdr
        for obu_data in obus:
            try:
                obu_mod.parse_obus(self._st, obu_data)
            except Exception as e:
                self._contain_error(e)
            if self._st.seq_hdr is not prev_seq:
                prev_seq = self._st.seq_hdr
                self._event_flags |= (EVENT_FLAG_NEW_SEQUENCE |
                                      EVENT_FLAG_NEW_OP_PARAMS_INFO)
            if self._st.frame_ready:
                self._st.frame_ready = False
                try:
                    self._handle_frame()
                except Exception as e:
                    self._contain_error(e)

    def _contain_error(self, e):
        st = self._st
        fhdr = st.frame_hdr
        if fhdr is not None and getattr(fhdr, "refresh_frame_flags", 0):
            for i in range(8):
                if (fhdr.refresh_frame_flags >> i) & 1:
                    self._errored_slots.add(i)
        st.frame_hdr = None
        st.tiles = []
        st.n_tiles = 0
        st.frame_ready = False
        self.last_error = e
        self._log(f"decode error contained: {e}")
        raise DecodeError(str(e)) from e

    # -- output ------------------------------------------------------------
    def get_picture(self) -> Picture | None:
        if not self._out:
            return None
        p = self._out.pop(0)
        ready = p.__dict__.pop("_ready", None)
        if ready is not None:
            try:
                ready.result()
            except Exception as e:  # contained like synchronous errors
                self.last_error = e
                raise DecodeError(str(e)) from e
        return p

    def apply_grain(self, pic: Picture) -> Picture:
        """dav1d_apply_grain (include/dav1d/dav1d.h:235): synthesize film
        grain onto an already-decoded picture, on the decoder's device,
        for callers who opened the decoder with apply_grain=False.
        Returns a new Picture (the input is left untouched)."""
        fhdr, seq = pic.frame_hdr, pic.seq_hdr
        if fhdr is None or not getattr(fhdr, "film_grain_present", 0):
            return pic
        # the grain pass reads luma column `width` / row `height` on odd
        # dimensions (the in-decoder pass grains the padded planes); a
        # Picture holds the cropped planes, so edge-replicate that pad
        planes = pic.planes
        pw, ph = pic.width & 1, pic.height & 1
        if pw or ph:
            planes = (np.pad(planes[0], ((0, ph), (0, pw)), mode="edge"),
                      ) + tuple(planes[1:])
        with stages.scope("grain", self.device):
            grained = apply_film_grain(
                [plane_to_torch(p, self.device) for p in planes], seq,
                fhdr, pic.width, pic.height)
            out = tuple(g.cpu().numpy().astype(p.dtype)
                        for g, p in zip(grained, pic.planes))
        if pw or ph:
            out = (out[0][:pic.height, :pic.width],) + out[1:]
        return replace(pic, planes=out)

    # -- internals ---------------------------------------------------------
    def _emit(self, bufs, fhdr):
        seq = self._st.seq_hdr
        st = self._st
        t35 = tuple(st.itut_t35)
        st.itut_t35 = []
        new_tu = st.new_temporal_unit
        st.new_temporal_unit = False
        w, hgt = bufs.width, bufs.height
        cw = (w + bufs.ss_hor) >> bufs.ss_hor
        ch = (hgt + bufs.ss_ver) >> bufs.ss_ver
        sizes = [(hgt, w)] + [(ch, cw)] * (len(bufs.planes) - 1)
        pic = Picture((), width=w, height=hgt,
                      bitdepth=seq.bitdepth, layout=seq.layout,
                      frame_hdr=fhdr, seq_hdr=seq,
                      content_light=st.content_light,
                      mastering_display=st.mastering_display,
                      itut_t35=t35, new_temporal_unit=new_tu)
        grain = self.s.apply_grain and fhdr.film_grain_present
        device = self.device

        def finalize():
            # a failed pixel or download stage surfaces here, at the
            # picture, and not as planes that were never filled
            gf = getattr(bufs, "_gather_fut", None)
            if gf is not None:
                gf.result()
            if grain:
                # grain device copies of the frame's planes; bufs keeps
                # the grain-free planes that later frames predict from
                with stages.scope("grain", device):
                    grained = apply_film_grain(bufs.dev_planes, seq, fhdr,
                                               w, hgt)
                    vis = [g[:y, :x].cpu().numpy().astype(p.dtype)
                           for g, p, (y, x) in zip(grained, bufs.planes,
                                                   sizes)]
            else:
                vis = [p[:y, :x] for p, (y, x) in zip(bufs.planes, sizes)]
            pic.planes = tuple(vis)

        if self._gather_pipe is not None:
            # ordered after the frame's download on the in-order worker
            pic._ready = self._gather_pipe.submit(finalize)
        else:
            finalize()
        self._queue_out(pic)

    def _queue_out(self, p):
        """Spatial-layer output gating (dav1d lib.c
        output_picture_ready:331): with all_layers off and a multi-
        spatial-layer operating point, hold one candidate per temporal
        unit and emit it when the top spatial layer arrives or the next
        temporal unit begins."""
        st = self._st
        if self.s.all_layers or not st.max_spatial_id:
            self._out.append(p)
            return
        c = self._sl_cache
        if c is not None and (
                c.frame_hdr.spatial_id == st.max_spatial_id or
                p.new_temporal_unit):
            self._out.append(c)
        self._sl_cache = p

    def drain(self):
        """End-of-input: release the held spatial-layer candidate."""
        if self._sl_cache is not None:
            self._out.append(self._sl_cache)
            self._sl_cache = None

    def _handle_frame(self):
        st = self._st
        seq, fhdr = st.seq_hdr, st.frame_hdr
        if fhdr.show_existing_frame:
            if self._skip_by_frame_type(
                    st.refs[fhdr.existing_frame_idx], False):
                st.tiles = []
                st.n_tiles = 0
                return
            bufs = self._refs[fhdr.existing_frame_idx]
            if bufs is None:
                raise DecodeError("show_existing of empty slot")
            self._emit(bufs, st.refs[fhdr.existing_frame_idx])
            st.tiles = []
            st.n_tiles = 0
            return
        if self._skip_by_frame_type(fhdr, True):
            # headers-only slot update (dav1d obu.c:1713-1726)
            for i in range(8):
                if (fhdr.refresh_frame_flags >> i) & 1:
                    st.refs[i] = fhdr
            st.tiles = []
            st.n_tiles = 0
            return
        bufs = self._decode_frame(seq, fhdr)
        if fhdr.show_frame or self.s.output_invisible_frames:
            self._emit(bufs, fhdr)
        st.tiles = []
        st.n_tiles = 0

    def _build(self, seq, fhdr, coders, bufs, refs, jnt_weights):
        """Build stage: plan and pack the frame's pixel program from its
        entropy products and the references' metadata (no pixels)."""
        _check_refs(fhdr, coders, refs)
        with stages.scope("plan"):
            if self.s.intra_engine and all_intra(coders):
                # the device intra engine's own program (models/intra)
                return build_intra_frame(seq, fhdr, coders, bufs)
            return build_frame_program(
                seq, fhdr, coders, bufs, refs, jnt_weights,
                intra_engine=bool(self.s.intra_engine))

    def _pixels(self, built, seq, fhdr, coders, bufs, refs, jnt_weights,
                download=True):
        """Pixel stage: run the built program on the device, then the
        filter chain. Returns the frame's filtered buffers (bufs, or new
        ones of the upscaled width on a super-res frame)."""
        device = self.device
        if self.s.intra_engine and all_intra(coders):
            with stages.scope("device", device):
                run_intra_frame(built, bufs, device)
        else:
            execute_frame_program(built, seq, fhdr, coders, bufs, device)
        return self._filter(seq, fhdr, coders, bufs, download)

    def _filter(self, seq, fhdr, coders, bufs, download=True):
        """The in-loop filter chain over a reconstructed frame; with
        `download`, then the planes' copy to the host, charged to the
        download stage (as the pipelined decoder's download job is)."""
        with stages.scope("filters", self.device):
            bufs = apply_inloop_filters(seq, fhdr, coders, bufs,
                                        self.device,
                                        filters_mask=self.s.inloop_filters)
        if download:
            with stages.scope("download"):
                download_planes(bufs)
        return bufs

    def _download(self, pixel_fut, bufs):
        """Download stage (in order, one job per frame; reference
        _gather_planes, api.py:148): wait for the frame's pixel job, copy
        its output planes into pinned host memory on the side stream once
        the pixel worker's event has fired, and fill bufs.planes."""
        pixel_fut.result()
        planes = bufs.dev_planes
        with stages.scope("download"):
            if self._dl_stream is not None:
                side = self._dl_stream
                with torch.cuda.stream(side):
                    side.wait_event(bufs._pixels_done)
                    host = []
                    for p in planes:
                        hp = torch.empty(p.shape, dtype=p.dtype,
                                         pin_memory=True)
                        hp.copy_(p, non_blocking=True)
                        p.record_stream(side)
                        host.append(hp)
                    done = torch.cuda.Event()
                    done.record(side)
                done.synchronize()
            else:
                host = planes
            for i, hp in enumerate(host):
                bufs.planes[i] = hp.numpy().astype(bufs.planes[i].dtype)
        return bufs

    def _skip_by_frame_type(self, fhdr, check_refresh):
        """Dav1dDecodeFrameType filtering (dav1d obu.c:1570-1700)."""
        dft = self.s.decode_frame_type
        if dft == DECODEFRAMETYPE_ALL or fhdr is None:
            return False
        non_ref = (check_refresh and dft == DECODEFRAMETYPE_REFERENCE and
                   not fhdr.refresh_frame_flags)
        if fhdr.frame_type in (h.INTER, h.SWITCH):
            return dft > DECODEFRAMETYPE_REFERENCE or non_ref
        if fhdr.frame_type == h.INTRA:
            return dft > DECODEFRAMETYPE_INTRA or non_ref
        return False

    def _decode_frame(self, seq, fhdr):
        st = self._st
        refs = self._refs
        if self.s.frame_size_limit and \
                fhdr.width[1] * fhdr.height > self.s.frame_size_limit:
            raise DecodeError("frame size over limit")
        keyframe = fhdr.frame_type in (0, 2)
        # strict mode: frames referencing error-poisoned slots are
        # themselves in error (dav1d decode.c:3296-3304)
        if not keyframe and self.s.strict_std_compliance and \
                self._errored_slots:
            for i in range(7):
                if fhdr.refidx[i] in self._errored_slots:
                    raise RuntimeError(
                        f"reference slot {fhdr.refidx[i]} is errored")
        rf = None
        ref_poc = None
        ref_scaled = None
        jnt_weights = None
        cur_w = fhdr.width[0]
        if keyframe and fhdr.allow_intrabc:
            from .host.refmvs import RefmvsFrame
            bw4f = ((cur_w + 7) >> 3) << 1
            bh4f = ((fhdr.height + 7) >> 3) << 1
            rf = RefmvsFrame(fhdr, seq, bw4f, bh4f)
        if not keyframe:
            from .host.refmvs import RefmvsFrame
            ref_poc = [st.refs[fhdr.refidx[i]].frame_offset
                       if st.refs[fhdr.refidx[i]] is not None else 0
                       for i in range(7)]
            bw4f = ((cur_w + 7) >> 3) << 1
            bh4f = ((fhdr.height + 7) >> 3) << 1
            rf = RefmvsFrame(fhdr, seq, bw4f, bh4f, ref_poc=ref_poc)
            rf.setup_temporal(
                seq, fhdr, ref_poc,
                [self._ref_refpoc[fhdr.refidx[i]] for i in range(7)],
                [self._ref_tmvs[fhdr.refidx[i]] for i in range(7)])
            if fhdr.switchable_comp_refs:
                jnt_weights = obu_mod.compute_jnt_weights(seq, fhdr,
                                                          ref_poc)
            ref_scaled = [
                refs[fhdr.refidx[i]] is not None and
                (refs[fhdr.refidx[i]].width != cur_w or
                 refs[fhdr.refidx[i]].height != fhdr.height)
                for i in range(7)]

        if fhdr.primary_ref_frame == h.PRIMARY_REF_NONE:
            cdf_in = new_cdf_context(qcat_from_qidx(fhdr.quant_yac))
        else:
            src = self._ref_cdfs[fhdr.refidx[fhdr.primary_ref_frame]]
            if src is None:
                raise DecodeError("missing primary-ref CDFs")
            cdf_in = src

        prev_segmap = None
        if fhdr.segmentation_enabled and \
                (fhdr.segmentation_temporal or
                 not fhdr.segmentation_update_map) and \
                fhdr.primary_ref_frame != h.PRIMARY_REF_NONE:
            prev_segmap = \
                self._ref_segmaps[fhdr.refidx[fhdr.primary_ref_frame]]

        coders = []
        t = fhdr.tiling
        with stages.scope("host-entropy"):
            for tile_row in range(t.rows):
                for tile_col in range(t.cols):
                    ti = tile_row * t.cols + tile_col
                    data_t, _, _ = _tile_payload(st, ti, fhdr)
                    coder = TileCoder(
                        seq, fhdr, cdf_in.copy(),
                        DecodeSide(NativeMsac(
                            data_t, bool(fhdr.disable_cdf_update))),
                        tile_col=tile_col, tile_row=tile_row, rf=rf,
                        ref_poc=ref_poc, ref_scaled=ref_scaled,
                        prev_segmap=prev_segmap)
                    native_tile.code_tile_native(coder)
                    coders.append(coder)

        # The pixel stage depends only on this frame's entropy products and
        # on reference PIXELS, which the in-order pixel worker has made by
        # the time its job runs. final_bufs is the frame's reference and
        # output buffer from now on; for a super-res frame the work
        # buffers are at the coded width (fhdr.width[0]) and the filter
        # chain's upscaled planes move into final_bufs.
        final_bufs = FrameBuffers(seq, fhdr, width=fhdr.width[1])
        work_bufs = (final_bufs if fhdr.width[0] == fhdr.width[1]
                     else FrameBuffers(seq, fhdr))
        frame = (seq, fhdr, coders, work_bufs, list(refs), jnt_weights)
        device = self.device
        pipelined = self._pipe is not None
        if pipelined:
            built_fut = self._build_pipe.submit(self._build, *frame)
        else:
            built_fut = _cf.Future()
            built_fut.set_result(self._build(*frame))

        def pixel_work():
            # a reference whose own pixel job failed fails this frame
            # too, with its error, as the reference's host path does
            # when it waits for its references' planes (api.py:761); the
            # in-order worker has finished those jobs already
            for rb in frame[4]:
                f = getattr(rb, "_pixel_fut", None)
                if f is not None:
                    f.result()
            out = self._pixels(built_fut.result(), *frame,
                               download=not pipelined)
            if out is not final_bufs:
                final_bufs.planes = out.planes
                final_bufs.dev_planes = out.dev_planes
            if device.type == "cuda" and pipelined:
                # the download stage waits on this, on its side stream
                final_bufs._pixels_done = torch.cuda.Event()
                final_bufs._pixels_done.record()
            return final_bufs

        if pipelined:
            fut = self._pipe.submit(pixel_work)
            final_bufs._pixel_fut = fut
            self._inflight.append(fut)
            gfut = self._gather_pipe.submit(self._download, fut, final_bufs)
            final_bufs._gather_fut = gfut
            self._ginflight.append(gfut)
            while len(self._ginflight) > self._frame_delay:
                self._ginflight.pop(0).result()
            while len(self._inflight) > self._frame_delay:
                self._inflight.pop(0).result()
        else:
            pixel_work()
        bufs = final_bufs

        # reference slot updates (entropy-stage products)
        out_cdf = cdf_thread_update(cdf_in,
                                    coders[fhdr.tiling.update].cdf,
                                    keyframe) if fhdr.refresh_context \
            else cdf_in
        cur_tmvs = None
        cur_refpoc = [0] * 7
        if not keyframe:
            rf.save_tmvs_frame()
            cur_tmvs = rf.rp
            cur_refpoc = ref_poc
        cur_segmap = None
        if fhdr.segmentation_enabled:
            if fhdr.segmentation_update_map:
                cur_segmap = coders[0].seg_map.copy()
                for c in coders[1:]:
                    cur_segmap[c.row_start:c.row_end,
                               c.col_start:c.col_end] = \
                        c.seg_map[c.row_start:c.row_end,
                                  c.col_start:c.col_end]
            else:
                cur_segmap = prev_segmap
        for i in range(8):
            if (fhdr.refresh_frame_flags >> i) & 1:
                refs[i] = bufs
                st.refs[i] = fhdr
                self._ref_cdfs[i] = out_cdf
                self._ref_tmvs[i] = cur_tmvs
                self._ref_refpoc[i] = cur_refpoc
                self._ref_segmaps[i] = cur_segmap
                self._errored_slots.discard(i)
        return bufs
