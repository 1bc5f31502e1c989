# Copied from dav1d_mirror_tpu/host/obu.py.
"""OBU-level parsing: framing, sequence/frame headers, tile groups.

Reference parity: dav1d src/obu.c (parse_seq_hdr:72, parse_frame_hdr:409,
parse_tile_hdr:1198, dav1d_parse_obus:1213). Inter-frame reference-dependent
paths (ref frame sizes, short signaling, primary-ref inheritance) consult the
decoder state's ref slots.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..utils.intops import ulog2
from .getbits import GetBits
from . import headers as h


class ParseError(Exception):
    pass


@dataclass
class TileGroup:
    data: bytes  # tile payload (post tile-group header)
    start: int = 0
    end: int = 0


@dataclass
class ObuState:
    """Cross-OBU decoder state (subset of Dav1dContext)."""
    seq_hdr: h.SequenceHeader | None = None
    frame_hdr: h.FrameHeader | None = None
    tiles: list = field(default_factory=list)
    n_tiles: int = 0
    refs: list = field(default_factory=lambda: [None] * 8)  # FrameHeader refs
    operating_point: int = 0
    operating_point_idc: int = 0
    frame_ready: bool = False  # all tile data in; submit frame
    # HDR metadata (dav1d obu.c:1400-1546): CLL/MDCV are "latest wins"
    # context state; T.35 messages accumulate until attached to a picture
    content_light: tuple | None = None        # (max_cll, max_fall)
    mastering_display: dict | None = None
    itut_t35: list = field(default_factory=list)
    new_temporal_unit: bool = True   # a TD arrived since the last frame
    max_spatial_id: int = 0          # from the selected operating point


def parse_seq_hdr(gb: GetBits) -> h.SequenceHeader:
    s = h.SequenceHeader()
    s.profile = gb.get_bits(3)
    if s.profile > 2:
        raise ParseError("profile")
    s.still_picture = gb.get_bit()
    s.reduced_still_picture_header = gb.get_bit()
    if s.reduced_still_picture_header and not s.still_picture:
        raise ParseError("reduced_still_picture")

    if s.reduced_still_picture_header:
        s.num_operating_points = 1
        op = h.OperatingPoint()
        op.major_level = gb.get_bits(3)
        op.minor_level = gb.get_bits(2)
        op.initial_display_delay = 10
        s.operating_points = [op]
    else:
        s.timing_info_present = gb.get_bit()
        if s.timing_info_present:
            s.num_units_in_tick = gb.get_bits(32)
            s.time_scale = gb.get_bits(32)
            s.equal_picture_interval = gb.get_bit()
            if s.equal_picture_interval:
                t = gb.get_vlc()
                if t == 0xFFFFFFFF:
                    raise ParseError("num_ticks_per_picture")
                s.num_ticks_per_picture = t + 1
            s.decoder_model_info_present = gb.get_bit()
            if s.decoder_model_info_present:
                s.encoder_decoder_buffer_delay_length = gb.get_bits(5) + 1
                s.num_units_in_decoding_tick = gb.get_bits(32)
                s.buffer_removal_delay_length = gb.get_bits(5) + 1
                s.frame_presentation_delay_length = gb.get_bits(5) + 1
        s.display_model_info_present = gb.get_bit()
        s.num_operating_points = gb.get_bits(5) + 1
        s.operating_points = []
        for _ in range(s.num_operating_points):
            op = h.OperatingPoint()
            op.idc = gb.get_bits(12)
            if op.idc and (not (op.idc & 0xFF) or not (op.idc & 0xF00)):
                raise ParseError("op idc")
            op.major_level = 2 + gb.get_bits(3)
            op.minor_level = gb.get_bits(2)
            if op.major_level > 3:
                op.tier = gb.get_bit()
            if s.decoder_model_info_present:
                op.decoder_model_param_present = gb.get_bit()
                if op.decoder_model_param_present:
                    gb.get_bits(s.encoder_decoder_buffer_delay_length)
                    gb.get_bits(s.encoder_decoder_buffer_delay_length)
                    gb.get_bit()
            if s.display_model_info_present:
                op.display_model_param_present = gb.get_bit()
            op.initial_display_delay = \
                gb.get_bits(4) + 1 if op.display_model_param_present else 10
            s.operating_points.append(op)

    s.width_n_bits = gb.get_bits(4) + 1
    s.height_n_bits = gb.get_bits(4) + 1
    s.max_width = gb.get_bits(s.width_n_bits) + 1
    s.max_height = gb.get_bits(s.height_n_bits) + 1
    if not s.reduced_still_picture_header:
        s.frame_id_numbers_present = gb.get_bit()
        if s.frame_id_numbers_present:
            s.delta_frame_id_n_bits = gb.get_bits(4) + 2
            s.frame_id_n_bits = gb.get_bits(3) + s.delta_frame_id_n_bits + 1
    s.sb128 = gb.get_bit()
    s.filter_intra = gb.get_bit()
    s.intra_edge_filter = gb.get_bit()
    if s.reduced_still_picture_header:
        s.screen_content_tools = h.ADAPTIVE
        s.force_integer_mv = h.ADAPTIVE
    else:
        s.inter_intra = gb.get_bit()
        s.masked_compound = gb.get_bit()
        s.warped_motion = gb.get_bit()
        s.dual_filter = gb.get_bit()
        s.order_hint = gb.get_bit()
        if s.order_hint:
            s.jnt_comp = gb.get_bit()
            s.ref_frame_mvs = gb.get_bit()
        s.screen_content_tools = h.ADAPTIVE if gb.get_bit() else gb.get_bit()
        s.force_integer_mv = (
            (h.ADAPTIVE if gb.get_bit() else gb.get_bit())
            if s.screen_content_tools else 2)
        if s.order_hint:
            s.order_hint_n_bits = gb.get_bits(3) + 1
    s.super_res = gb.get_bit()
    s.cdef = gb.get_bit()
    s.restoration = gb.get_bit()
    s.hbd = gb.get_bit()
    if s.profile == 2 and s.hbd:
        s.hbd += gb.get_bit()
    if s.profile != 1:
        s.monochrome = gb.get_bit()
    s.color_description_present = gb.get_bit()
    if s.color_description_present:
        s.pri = gb.get_bits(8)
        s.trc = gb.get_bits(8)
        s.mtrx = gb.get_bits(8)
    else:
        s.pri, s.trc, s.mtrx = 2, 2, 2
    if s.monochrome:
        s.color_range = gb.get_bit()
        s.layout = h.PIXEL_LAYOUT_I400
        s.ss_hor = s.ss_ver = 1
        s.chr = 0
    elif s.pri == 1 and s.trc == 13 and s.mtrx == 0:
        s.layout = h.PIXEL_LAYOUT_I444
        s.color_range = 1
        s.ss_hor = s.ss_ver = 0
    else:
        s.color_range = gb.get_bit()
        if s.profile == 0:
            s.layout = h.PIXEL_LAYOUT_I420
            s.ss_hor = s.ss_ver = 1
        elif s.profile == 1:
            s.layout = h.PIXEL_LAYOUT_I444
            s.ss_hor = s.ss_ver = 0
        else:
            if s.hbd == 2:
                s.ss_hor = gb.get_bit()
                s.ss_ver = s.ss_hor and gb.get_bit()
            else:
                s.ss_hor, s.ss_ver = 1, 0
            s.layout = (h.PIXEL_LAYOUT_I420 if s.ss_ver else
                        h.PIXEL_LAYOUT_I422) if s.ss_hor else \
                h.PIXEL_LAYOUT_I444
        s.chr = gb.get_bits(2) if (s.ss_hor & s.ss_ver) else 0
    if not s.monochrome:
        s.separate_uv_delta_q = gb.get_bit()
    s.film_grain_present = gb.get_bit()
    gb.get_bit()  # trailing bit
    if gb.error:
        raise ParseError("overrun in sequence header")
    return s


def _read_frame_size(st: ObuState, gb: GetBits, use_ref: bool):
    seq = st.seq_hdr
    hdr = st.frame_hdr
    if use_ref:
        for i in range(7):
            if gb.get_bit():
                ref = st.refs[hdr.refidx[i]]
                if ref is None:
                    raise ParseError("ref frame size")
                hdr.width[1] = ref.width[1]
                hdr.height = ref.height
                hdr.render_width = ref.render_width
                hdr.render_height = ref.render_height
                hdr.super_res_enabled = seq.super_res and gb.get_bit()
                if hdr.super_res_enabled:
                    d = 9 + gb.get_bits(3)
                    hdr.super_res_width_scale_denominator = d
                    hdr.width[0] = max((hdr.width[1] * 8 + (d >> 1)) // d,
                                       min(16, hdr.width[1]))
                else:
                    hdr.super_res_width_scale_denominator = 8
                    hdr.width[0] = hdr.width[1]
                return
    if hdr.frame_size_override:
        hdr.width[1] = gb.get_bits(seq.width_n_bits) + 1
        hdr.height = gb.get_bits(seq.height_n_bits) + 1
    else:
        hdr.width[1] = seq.max_width
        hdr.height = seq.max_height
    hdr.super_res_enabled = seq.super_res and gb.get_bit()
    if hdr.super_res_enabled:
        d = 9 + gb.get_bits(3)
        hdr.super_res_width_scale_denominator = d
        hdr.width[0] = max((hdr.width[1] * 8 + (d >> 1)) // d,
                           min(16, hdr.width[1]))
    else:
        hdr.super_res_width_scale_denominator = 8
        hdr.width[0] = hdr.width[1]
    hdr.have_render_size = gb.get_bit()
    if hdr.have_render_size:
        hdr.render_width = gb.get_bits(16) + 1
        hdr.render_height = gb.get_bits(16) + 1
    else:
        hdr.render_width = hdr.width[1]
        hdr.render_height = hdr.height


def derive_lossless(hdr: h.FrameHeader):
    """Per-segment qidx + lossless flags (dav1d src/obu.c:848-859); shared
    by the parser and the test-stream generator."""
    delta_lossless = (not hdr.quant_ydc_delta and not hdr.quant_udc_delta
                      and not hdr.quant_uac_delta and not hdr.quant_vdc_delta
                      and not hdr.quant_vac_delta)
    hdr.all_lossless = 1
    for i in range(h.MAX_SEGMENTS):
        q = hdr.quant_yac + hdr.seg_data.d[i].delta_q \
            if hdr.segmentation_enabled else hdr.quant_yac
        hdr.segmentation_qidx[i] = max(0, min(255, q))
        hdr.segmentation_lossless[i] = int(
            not hdr.segmentation_qidx[i] and delta_lossless)
        hdr.all_lossless &= hdr.segmentation_lossless[i]


def _tile_log2(sz: int, tgt: int) -> int:
    k = 0
    while (sz << k) < tgt:
        k += 1
    return k


def compute_uniform_tiling(seq: h.SequenceHeader, hdr: h.FrameHeader):
    """Fill hdr.tiling cols/rows/start arrays for uniform tiling from
    log2_cols/log2_rows (shared by the parser and the stream generator)."""
    t = hdr.tiling
    assert t.uniform
    sbsz_min1 = (64 << seq.sb128) - 1
    sbsz_log2 = 6 + seq.sb128
    sbw = (hdr.width[0] + sbsz_min1) >> sbsz_log2
    sbh = (hdr.height + sbsz_min1) >> sbsz_log2
    tile_w = 1 + ((sbw - 1) >> t.log2_cols)
    t.cols = 0
    sbx = 0
    while sbx < sbw:
        t.col_start_sb[t.cols] = sbx
        sbx += tile_w
        t.cols += 1
    tile_h = 1 + ((sbh - 1) >> t.log2_rows)
    t.rows = 0
    sby = 0
    while sby < sbh:
        t.row_start_sb[t.rows] = sby
        sby += tile_h
        t.rows += 1
    t.col_start_sb[t.cols] = sbw
    t.row_start_sb[t.rows] = sbh
    if t.log2_cols or t.log2_rows:
        if not t.n_bytes:
            t.n_bytes = 4
    return t


def parse_frame_hdr(st: ObuState, gb: GetBits):  # noqa: C901
    seq = st.seq_hdr
    hdr = st.frame_hdr

    hdr.show_existing_frame = \
        (not seq.reduced_still_picture_header) and gb.get_bit()
    if hdr.show_existing_frame:
        hdr.existing_frame_idx = gb.get_bits(3)
        if seq.decoder_model_info_present and not seq.equal_picture_interval:
            hdr.frame_presentation_delay = \
                gb.get_bits(seq.frame_presentation_delay_length)
        if seq.frame_id_numbers_present:
            hdr.frame_id = gb.get_bits(seq.frame_id_n_bits)
        return

    hdr.frame_type = h.KEY if seq.reduced_still_picture_header \
        else gb.get_bits(2)
    hdr.show_frame = seq.reduced_still_picture_header or gb.get_bit()
    if hdr.show_frame:
        if seq.decoder_model_info_present and not seq.equal_picture_interval:
            hdr.frame_presentation_delay = \
                gb.get_bits(seq.frame_presentation_delay_length)
        hdr.showable_frame = hdr.frame_type != h.KEY
    else:
        hdr.showable_frame = gb.get_bit()
    hdr.error_resilient_mode = (
        (hdr.frame_type == h.KEY and hdr.show_frame) or
        hdr.frame_type == h.SWITCH or
        seq.reduced_still_picture_header or gb.get_bit())
    hdr.disable_cdf_update = gb.get_bit()
    hdr.allow_screen_content_tools = (
        gb.get_bit() if seq.screen_content_tools == h.ADAPTIVE
        else seq.screen_content_tools)
    if hdr.allow_screen_content_tools:
        hdr.force_integer_mv = (
            gb.get_bit() if seq.force_integer_mv == h.ADAPTIVE
            else seq.force_integer_mv)
    else:
        hdr.force_integer_mv = 0
    if h.is_key_or_intra(hdr):
        hdr.force_integer_mv = 1
    if seq.frame_id_numbers_present:
        hdr.frame_id = gb.get_bits(seq.frame_id_n_bits)
    hdr.frame_size_override = (
        0 if seq.reduced_still_picture_header else
        1 if hdr.frame_type == h.SWITCH else gb.get_bit())
    hdr.frame_offset = gb.get_bits(seq.order_hint_n_bits) \
        if seq.order_hint else 0
    hdr.primary_ref_frame = (
        gb.get_bits(3) if not hdr.error_resilient_mode
        and h.is_inter_or_switch(hdr) else h.PRIMARY_REF_NONE)

    if seq.decoder_model_info_present:
        hdr.buffer_removal_time_present = gb.get_bit()
        if hdr.buffer_removal_time_present:
            for i in range(seq.num_operating_points):
                op = seq.operating_points[i]
                if op.decoder_model_param_present:
                    in_t = (op.idc >> hdr.temporal_id) & 1
                    in_s = (op.idc >> (hdr.spatial_id + 8)) & 1
                    if not op.idc or (in_t and in_s):
                        gb.get_bits(seq.buffer_removal_delay_length)

    if h.is_key_or_intra(hdr):
        hdr.refresh_frame_flags = (
            0xFF if hdr.frame_type == h.KEY and hdr.show_frame
            else gb.get_bits(8))
        if hdr.refresh_frame_flags != 0xFF and hdr.error_resilient_mode \
                and seq.order_hint:
            for _ in range(8):
                gb.get_bits(seq.order_hint_n_bits)
        _read_frame_size(st, gb, False)
        hdr.allow_intrabc = (hdr.allow_screen_content_tools and
                             not hdr.super_res_enabled and gb.get_bit())
        hdr.use_ref_frame_mvs = 0
    else:
        hdr.allow_intrabc = 0
        hdr.refresh_frame_flags = (0xFF if hdr.frame_type == h.SWITCH
                                   else gb.get_bits(8))
        if hdr.error_resilient_mode and seq.order_hint:
            for _ in range(8):
                gb.get_bits(seq.order_hint_n_bits)
        hdr.frame_ref_short_signaling = seq.order_hint and gb.get_bit()
        if hdr.frame_ref_short_signaling:
            hdr.refidx = _short_ref_signaling(st, gb, hdr, seq)
        for i in range(7):
            if not hdr.frame_ref_short_signaling:
                hdr.refidx[i] = gb.get_bits(3)
            if seq.frame_id_numbers_present:
                gb.get_bits(seq.delta_frame_id_n_bits)
        use_ref = not hdr.error_resilient_mode and hdr.frame_size_override
        _read_frame_size(st, gb, use_ref)
        hdr.hp = (not hdr.force_integer_mv) and gb.get_bit()
        hdr.subpel_filter_mode = h.FILTER_SWITCHABLE if gb.get_bit() \
            else gb.get_bits(2)
        hdr.switchable_motion_mode = gb.get_bit()
        hdr.use_ref_frame_mvs = (
            not hdr.error_resilient_mode and seq.ref_frame_mvs and
            seq.order_hint and h.is_inter_or_switch(hdr) and gb.get_bit())

    hdr.refresh_context = (not seq.reduced_still_picture_header and
                           not hdr.disable_cdf_update and not gb.get_bit())

    # tiling
    t = hdr.tiling
    t.uniform = gb.get_bit()
    sbsz_min1 = (64 << seq.sb128) - 1
    sbsz_log2 = 6 + seq.sb128
    sbw = (hdr.width[0] + sbsz_min1) >> sbsz_log2
    sbh = (hdr.height + sbsz_min1) >> sbsz_log2
    max_tile_width_sb = 4096 >> sbsz_log2
    max_tile_area_sb = (4096 * 2304) >> (2 * sbsz_log2)
    t.min_log2_cols = _tile_log2(max_tile_width_sb, sbw)
    t.max_log2_cols = _tile_log2(1, min(sbw, h.MAX_TILE_COLS))
    t.max_log2_rows = _tile_log2(1, min(sbh, h.MAX_TILE_ROWS))
    min_log2_tiles = max(_tile_log2(max_tile_area_sb, sbw * sbh),
                         t.min_log2_cols)
    if t.uniform:
        t.log2_cols = t.min_log2_cols
        while t.log2_cols < t.max_log2_cols and gb.get_bit():
            t.log2_cols += 1
        tile_w = 1 + ((sbw - 1) >> t.log2_cols)
        t.cols = 0
        sbx = 0
        while sbx < sbw:
            t.col_start_sb[t.cols] = sbx
            sbx += tile_w
            t.cols += 1
        t.min_log2_rows = max(min_log2_tiles - t.log2_cols, 0)
        t.log2_rows = t.min_log2_rows
        while t.log2_rows < t.max_log2_rows and gb.get_bit():
            t.log2_rows += 1
        tile_h = 1 + ((sbh - 1) >> t.log2_rows)
        t.rows = 0
        sby = 0
        while sby < sbh:
            t.row_start_sb[t.rows] = sby
            sby += tile_h
            t.rows += 1
    else:
        t.cols = 0
        widest_tile = 0
        max_area = sbw * sbh
        sbx = 0
        while sbx < sbw and t.cols < h.MAX_TILE_COLS:
            tile_width_sb = min(sbw - sbx, max_tile_width_sb)
            tile_w = 1 + gb.get_uniform(tile_width_sb) \
                if tile_width_sb > 1 else 1
            t.col_start_sb[t.cols] = sbx
            sbx += tile_w
            widest_tile = max(widest_tile, tile_w)
            t.cols += 1
        t.log2_cols = _tile_log2(1, t.cols)
        if min_log2_tiles:
            max_area >>= min_log2_tiles + 1
        max_tile_height_sb = max(max_area // widest_tile, 1)
        t.rows = 0
        sby = 0
        while sby < sbh and t.rows < h.MAX_TILE_ROWS:
            tile_height_sb = min(sbh - sby, max_tile_height_sb)
            tile_h = 1 + gb.get_uniform(tile_height_sb) \
                if tile_height_sb > 1 else 1
            t.row_start_sb[t.rows] = sby
            sby += tile_h
            t.rows += 1
        t.log2_rows = _tile_log2(1, t.rows)
    t.col_start_sb[t.cols] = sbw
    t.row_start_sb[t.rows] = sbh
    if t.log2_cols or t.log2_rows:
        t.update = gb.get_bits(t.log2_cols + t.log2_rows)
        if t.update >= t.cols * t.rows:
            raise ParseError("tiling update")
        t.n_bytes = gb.get_bits(2) + 1
    else:
        t.n_bytes = t.update = 0

    # quant
    hdr.quant_yac = gb.get_bits(8)
    hdr.quant_ydc_delta = gb.get_sbits(7) if gb.get_bit() else 0
    if not seq.monochrome:
        diff_uv_delta = gb.get_bit() if seq.separate_uv_delta_q else 0
        hdr.quant_udc_delta = gb.get_sbits(7) if gb.get_bit() else 0
        hdr.quant_uac_delta = gb.get_sbits(7) if gb.get_bit() else 0
        if diff_uv_delta:
            hdr.quant_vdc_delta = gb.get_sbits(7) if gb.get_bit() else 0
            hdr.quant_vac_delta = gb.get_sbits(7) if gb.get_bit() else 0
        else:
            hdr.quant_vdc_delta = hdr.quant_udc_delta
            hdr.quant_vac_delta = hdr.quant_uac_delta
    hdr.quant_qm = gb.get_bit()
    if hdr.quant_qm:
        hdr.quant_qm_y = gb.get_bits(4)
        hdr.quant_qm_u = gb.get_bits(4)
        hdr.quant_qm_v = gb.get_bits(4) if seq.separate_uv_delta_q \
            else hdr.quant_qm_u

    # segmentation
    hdr.segmentation_enabled = gb.get_bit()
    if hdr.segmentation_enabled:
        if hdr.primary_ref_frame == h.PRIMARY_REF_NONE:
            hdr.segmentation_update_map = 1
            hdr.segmentation_temporal = 0
            hdr.segmentation_update_data = 1
        else:
            hdr.segmentation_update_map = gb.get_bit()
            hdr.segmentation_temporal = \
                gb.get_bit() if hdr.segmentation_update_map else 0
            hdr.segmentation_update_data = gb.get_bit()
        if hdr.segmentation_update_data:
            sd = hdr.seg_data = h.SegmentationDataSet()
            sd.preskip = 0
            sd.last_active_segid = -1
            for i in range(h.MAX_SEGMENTS):
                seg = sd.d[i]
                if gb.get_bit():
                    seg.delta_q = gb.get_sbits(9)
                    sd.last_active_segid = i
                if gb.get_bit():
                    seg.delta_lf_y_v = gb.get_sbits(7)
                    sd.last_active_segid = i
                if gb.get_bit():
                    seg.delta_lf_y_h = gb.get_sbits(7)
                    sd.last_active_segid = i
                if gb.get_bit():
                    seg.delta_lf_u = gb.get_sbits(7)
                    sd.last_active_segid = i
                if gb.get_bit():
                    seg.delta_lf_v = gb.get_sbits(7)
                    sd.last_active_segid = i
                if gb.get_bit():
                    seg.ref = gb.get_bits(3)
                    sd.last_active_segid = i
                    sd.preskip = 1
                seg.skip = gb.get_bit()
                if seg.skip:
                    sd.last_active_segid = i
                    sd.preskip = 1
                seg.globalmv = gb.get_bit()
                if seg.globalmv:
                    sd.last_active_segid = i
                    sd.preskip = 1
        else:
            pri_ref = hdr.refidx[hdr.primary_ref_frame]
            if st.refs[pri_ref] is None:
                raise ParseError("seg pri ref")
            hdr.seg_data = st.refs[pri_ref].seg_data
    else:
        hdr.seg_data = h.SegmentationDataSet()

    # delta q/lf
    hdr.delta_q_present = gb.get_bit() if hdr.quant_yac else 0
    hdr.delta_q_res_log2 = gb.get_bits(2) if hdr.delta_q_present else 0
    hdr.delta_lf_present = (hdr.delta_q_present and not hdr.allow_intrabc
                            and gb.get_bit())
    hdr.delta_lf_res_log2 = gb.get_bits(2) if hdr.delta_lf_present else 0
    hdr.delta_lf_multi = gb.get_bit() if hdr.delta_lf_present else 0

    derive_lossless(hdr)

    # loopfilter
    if hdr.all_lossless or hdr.allow_intrabc:
        hdr.loopfilter_level_y = [0, 0]
        hdr.loopfilter_level_u = hdr.loopfilter_level_v = 0
        hdr.loopfilter_sharpness = 0
        hdr.loopfilter_mode_ref_delta_enabled = 1
        hdr.loopfilter_mode_ref_delta_update = 1
        hdr.loopfilter_mode_ref_deltas = h.LoopfilterModeRefDeltas()
    else:
        hdr.loopfilter_level_y = [gb.get_bits(6), gb.get_bits(6)]
        if not seq.monochrome and (hdr.loopfilter_level_y[0] or
                                   hdr.loopfilter_level_y[1]):
            hdr.loopfilter_level_u = gb.get_bits(6)
            hdr.loopfilter_level_v = gb.get_bits(6)
        hdr.loopfilter_sharpness = gb.get_bits(3)
        if hdr.primary_ref_frame == h.PRIMARY_REF_NONE:
            hdr.loopfilter_mode_ref_deltas = h.LoopfilterModeRefDeltas()
        else:
            ref = hdr.refidx[hdr.primary_ref_frame]
            if st.refs[ref] is None:
                raise ParseError("lf pri ref")
            import copy
            hdr.loopfilter_mode_ref_deltas = \
                copy.deepcopy(st.refs[ref].loopfilter_mode_ref_deltas)
        hdr.loopfilter_mode_ref_delta_enabled = gb.get_bit()
        if hdr.loopfilter_mode_ref_delta_enabled:
            hdr.loopfilter_mode_ref_delta_update = gb.get_bit()
            if hdr.loopfilter_mode_ref_delta_update:
                for i in range(8):
                    if gb.get_bit():
                        hdr.loopfilter_mode_ref_deltas.ref_delta[i] = \
                            gb.get_sbits(7)
                for i in range(2):
                    if gb.get_bit():
                        hdr.loopfilter_mode_ref_deltas.mode_delta[i] = \
                            gb.get_sbits(7)

    # cdef
    if not hdr.all_lossless and seq.cdef and not hdr.allow_intrabc:
        hdr.cdef_damping = gb.get_bits(2) + 3
        hdr.cdef_n_bits = gb.get_bits(2)
        for i in range(1 << hdr.cdef_n_bits):
            hdr.cdef_y_strength[i] = gb.get_bits(6)
            if not seq.monochrome:
                hdr.cdef_uv_strength[i] = gb.get_bits(6)
    else:
        hdr.cdef_n_bits = 0
        hdr.cdef_y_strength[0] = 0
        hdr.cdef_uv_strength[0] = 0

    # restoration
    if (not hdr.all_lossless or hdr.super_res_enabled) and \
            seq.restoration and not hdr.allow_intrabc:
        hdr.restoration_type = [gb.get_bits(2)]
        if not seq.monochrome:
            hdr.restoration_type += [gb.get_bits(2), gb.get_bits(2)]
        else:
            hdr.restoration_type += [h.RESTORATION_NONE, h.RESTORATION_NONE]
        if any(hdr.restoration_type):
            us = 6 + seq.sb128
            if gb.get_bit():
                us += 1
                if not seq.sb128:
                    us += gb.get_bit()
            hdr.restoration_unit_size = [us, us]
            if (hdr.restoration_type[1] or hdr.restoration_type[2]) and \
                    seq.ss_hor == 1 and seq.ss_ver == 1:
                hdr.restoration_unit_size[1] -= gb.get_bit()
        else:
            hdr.restoration_unit_size = [8, 8]
    else:
        hdr.restoration_type = [h.RESTORATION_NONE] * 3

    hdr.txfm_mode = (h.TX_4X4_ONLY if hdr.all_lossless else
                     h.TX_SWITCHABLE if gb.get_bit() else h.TX_LARGEST)
    hdr.switchable_comp_refs = gb.get_bit() \
        if h.is_inter_or_switch(hdr) else 0
    hdr.skip_mode_allowed = 0
    if hdr.switchable_comp_refs and h.is_inter_or_switch(hdr) \
            and seq.order_hint:
        _derive_skip_mode_refs(st, gb)
    hdr.skip_mode_enabled = gb.get_bit() if hdr.skip_mode_allowed else 0
    hdr.warp_motion = (not hdr.error_resilient_mode and
                       h.is_inter_or_switch(hdr) and seq.warped_motion and
                       gb.get_bit())
    hdr.reduced_txtp_set = gb.get_bit()

    hdr.gmv = [h.WarpedMotionParams() for _ in range(7)]
    if h.is_inter_or_switch(hdr):
        for i in range(7):
            g = hdr.gmv[i]
            g.type = (h.WM_TYPE_IDENTITY if not gb.get_bit() else
                      h.WM_TYPE_ROT_ZOOM if gb.get_bit() else
                      h.WM_TYPE_TRANSLATION if gb.get_bit() else
                      h.WM_TYPE_AFFINE)
            if g.type == h.WM_TYPE_IDENTITY:
                continue
            if hdr.primary_ref_frame == h.PRIMARY_REF_NONE:
                ref_gmv = h.WarpedMotionParams()
            else:
                pri_ref = hdr.refidx[hdr.primary_ref_frame]
                if st.refs[pri_ref] is None:
                    raise ParseError("gmv pri ref")
                ref_gmv = st.refs[pri_ref].gmv[i]
            mat = g.matrix
            ref_mat = ref_gmv.matrix
            if g.type >= h.WM_TYPE_ROT_ZOOM:
                mat[2] = (1 << 16) + 2 * gb.get_bits_subexp(
                    (ref_mat[2] - (1 << 16)) >> 1, 12)
                mat[3] = 2 * gb.get_bits_subexp(ref_mat[3] >> 1, 12)
                bits, shift = 12, 10
            else:
                bits, shift = 9 - (not hdr.hp), 13 + (not hdr.hp)
            if g.type == h.WM_TYPE_AFFINE:
                mat[4] = 2 * gb.get_bits_subexp(ref_mat[4] >> 1, 12)
                mat[5] = (1 << 16) + 2 * gb.get_bits_subexp(
                    (ref_mat[5] - (1 << 16)) >> 1, 12)
            else:
                mat[4] = -mat[3]
                mat[5] = mat[2]
            mat[0] = gb.get_bits_subexp(ref_mat[0] >> shift, bits) \
                * (1 << shift)
            mat[1] = gb.get_bits_subexp(ref_mat[1] >> shift, bits) \
                * (1 << shift)

    # film grain
    hdr.film_grain_present = (seq.film_grain_present and
                              (hdr.show_frame or hdr.showable_frame) and
                              gb.get_bit())
    if hdr.film_grain_present:
        seed = gb.get_bits(16)
        hdr.film_grain_update = \
            hdr.frame_type != h.INTER or gb.get_bit()
        if not hdr.film_grain_update:
            refidx = gb.get_bits(3)
            found = any(hdr.refidx[i] == refidx for i in range(7))
            if not found or st.refs[refidx] is None:
                raise ParseError("film grain ref")
            import copy
            hdr.film_grain_data = \
                copy.deepcopy(st.refs[refidx].film_grain_data)
            hdr.film_grain_data.seed = seed
        else:
            fgd = hdr.film_grain_data = h.FilmGrainData()
            fgd.seed = seed
            fgd.num_y_points = gb.get_bits(4)
            if fgd.num_y_points > 14:
                raise ParseError("fg y points")
            fgd.y_points = []
            for i in range(fgd.num_y_points):
                x = gb.get_bits(8)
                if i and fgd.y_points[i - 1][0] >= x:
                    raise ParseError("fg y points order")
                fgd.y_points.append((x, gb.get_bits(8)))
            fgd.chroma_scaling_from_luma = \
                (not seq.monochrome) and gb.get_bit()
            if seq.monochrome or fgd.chroma_scaling_from_luma or \
                    (seq.ss_ver == 1 and seq.ss_hor == 1 and
                     not fgd.num_y_points):
                fgd.num_uv_points = [0, 0]
            else:
                for pl in range(2):
                    fgd.num_uv_points[pl] = gb.get_bits(4)
                    if fgd.num_uv_points[pl] > 10:
                        raise ParseError("fg uv points")
                    fgd.uv_points[pl] = []
                    for i in range(fgd.num_uv_points[pl]):
                        x = gb.get_bits(8)
                        if i and fgd.uv_points[pl][i - 1][0] >= x:
                            raise ParseError("fg uv points order")
                        fgd.uv_points[pl].append((x, gb.get_bits(8)))
            if seq.ss_hor == 1 and seq.ss_ver == 1 and \
                    bool(fgd.num_uv_points[0]) != bool(fgd.num_uv_points[1]):
                raise ParseError("fg uv point mismatch")
            fgd.scaling_shift = gb.get_bits(2) + 8
            fgd.ar_coeff_lag = gb.get_bits(2)
            num_y_pos = 2 * fgd.ar_coeff_lag * (fgd.ar_coeff_lag + 1)
            if fgd.num_y_points:
                for i in range(num_y_pos):
                    fgd.ar_coeffs_y[i] = gb.get_bits(8) - 128
            for pl in range(2):
                if fgd.num_uv_points[pl] or fgd.chroma_scaling_from_luma:
                    num_uv_pos = num_y_pos + bool(fgd.num_y_points)
                    for i in range(num_uv_pos):
                        fgd.ar_coeffs_uv[pl][i] = gb.get_bits(8) - 128
                    if not fgd.num_y_points:
                        fgd.ar_coeffs_uv[pl][num_uv_pos] = 0
            fgd.ar_coeff_shift = gb.get_bits(2) + 6
            fgd.grain_scale_shift = gb.get_bits(2)
            for pl in range(2):
                if fgd.num_uv_points[pl]:
                    fgd.uv_mult[pl] = gb.get_bits(8) - 128
                    fgd.uv_luma_mult[pl] = gb.get_bits(8) - 128
                    fgd.uv_offset[pl] = gb.get_bits(9) - 256
            fgd.overlap_flag = gb.get_bit()
            fgd.clip_to_restricted_range = gb.get_bit()
    else:
        hdr.film_grain_data = h.FilmGrainData()

    if gb.error:
        raise ParseError("overrun in frame header")


def _short_ref_signaling(st: ObuState, gb: GetBits, hdr, seq):
    last = gb.get_bits(3)
    gold = gb.get_bits(3)
    if any(r is None for r in st.refs):
        raise ParseError("short ref signaling without full ref state")
    return derive_short_refs(seq, hdr.frame_offset,
                             [r.frame_offset for r in st.refs], last, gold)


def derive_short_refs(seq, frame_offset, ref_offsets, last, gold):
    """AV1 spec 7.8 set_frame_refs (dav1d src/obu.c:518-607): only the
    LAST and GOLDEN slot indices are coded; the other five are derived
    from the reference slots' order hints relative to this frame."""
    refidx = [-1] * 7
    refidx[0] = last
    refidx[3] = gold

    cur = 1 << (seq.order_hint_n_bits - 1)
    shifted = [cur + get_poc_diff(seq.order_hint_n_bits, ref_offsets[i],
                                  frame_offset) for i in range(8)]
    used = [False] * 8
    used[refidx[0]] = used[refidx[3]] = True

    def pick(pred, best_of):
        """Best unused slot whose shifted hint satisfies pred."""
        best, best_hint = -1, None
        for i in range(8):
            hint = shifted[i]
            if used[i] or not pred(hint):
                continue
            if best_hint is None or best_of(hint, best_hint):
                best, best_hint = i, hint
        if best >= 0:
            used[best] = True
        return best

    # ALTREF: latest backward; BWDREF/ALTREF2: two earliest backward
    refidx[6] = pick(lambda hnt: hnt >= cur, lambda a, b: a >= b)
    refidx[4] = pick(lambda hnt: hnt >= cur, lambda a, b: a < b)
    refidx[5] = pick(lambda hnt: hnt >= cur, lambda a, b: a < b)
    # remaining slots: latest forward refs
    for i in range(1, 7):
        if refidx[i] < 0:
            refidx[i] = pick(lambda hnt: hnt < cur, lambda a, b: a >= b)
    # any still unset: the overall earliest
    earliest = min(range(8), key=lambda i: shifted[i])
    return [r if r >= 0 else earliest for r in refidx]


def get_poc_diff(order_hint_n_bits: int, poc0: int, poc1: int) -> int:
    """dav1d env.h get_poc_diff:237 (wrapped order-hint difference)."""
    if not order_hint_n_bits:
        return 0
    mask = 1 << (order_hint_n_bits - 1)
    diff = poc0 - poc1
    return (diff & (mask - 1)) - (diff & mask)


def derive_skip_mode(seq: h.SequenceHeader, hdr: h.FrameHeader, refs):
    """dav1d obu.c:980-1035: find nearest fwd+bwd (or two nearest fwd)
    refs; sets hdr.skip_mode_allowed/skip_mode_refs. refs: 8 FrameHeaders."""
    hdr.skip_mode_allowed = 0
    poc = hdr.frame_offset
    nb = seq.order_hint_n_bits
    off_before = off_after = None
    off_before_idx = off_after_idx = -1
    for i in range(7):
        rh = refs[hdr.refidx[i]]
        if rh is None:
            raise ParseError("skip mode ref missing")
        refpoc = rh.frame_offset
        diff = get_poc_diff(nb, refpoc, poc)
        if diff > 0:
            if off_after is None or get_poc_diff(nb, off_after, refpoc) > 0:
                off_after, off_after_idx = refpoc, i
        elif diff < 0 and (off_before is None or
                           get_poc_diff(nb, refpoc, off_before) > 0):
            off_before, off_before_idx = refpoc, i
    if off_before is not None and off_after is not None:
        hdr.skip_mode_refs = [min(off_before_idx, off_after_idx),
                              max(off_before_idx, off_after_idx)]
        hdr.skip_mode_allowed = 1
    elif off_before is not None:
        off_before2 = None
        off_before2_idx = -1
        for i in range(7):
            rh = refs[hdr.refidx[i]]
            if rh is None:
                raise ParseError("skip mode ref missing")
            refpoc = rh.frame_offset
            if get_poc_diff(nb, refpoc, off_before) < 0:
                if off_before2 is None or \
                        get_poc_diff(nb, refpoc, off_before2) > 0:
                    off_before2, off_before2_idx = refpoc, i
        if off_before2 is not None:
            hdr.skip_mode_refs = [min(off_before_idx, off_before2_idx),
                                  max(off_before_idx, off_before2_idx)]
            hdr.skip_mode_allowed = 1


def compute_jnt_weights(seq: h.SequenceHeader, hdr: h.FrameHeader,
                        ref_poc):
    """dav1d decode.c:3132-3163: distance-weighted compound weights.
    ref_poc: frame_offset of the 7 refidx-resolved references."""
    qdw = ((2, 3), (2, 5), (2, 7))
    qdlt = ((9, 7), (11, 5), (12, 4), (13, 3))
    nb = seq.order_hint_n_bits
    poc = hdr.frame_offset
    w = [[0] * 7 for _ in range(7)]
    for i in range(7):
        for j in range(i + 1, 7):
            d1 = min(abs(get_poc_diff(nb, ref_poc[i], poc)), 31)
            d0 = min(abs(get_poc_diff(nb, ref_poc[j], poc)), 31)
            order = int(d0 <= d1)
            for k in range(3):
                c0 = qdw[k][order]
                c1 = qdw[k][1 - order]
                if (d0 > d1 and d0 * c0 < d1 * c1) or \
                        (d0 <= d1 and d0 * c0 > d1 * c1):
                    break
            else:
                k = 3
            w[i][j] = qdlt[k][order]
    return w


def _derive_skip_mode_refs(st: ObuState, gb: GetBits):
    derive_skip_mode(st.seq_hdr, st.frame_hdr, st.refs)


def parse_obus(st: ObuState, data: bytes) -> int:
    """Parse one OBU from data; returns bytes consumed. Sets st.frame_ready
    when a full frame's tiles have arrived."""
    gb = GetBits(data)
    gb.get_bit()  # forbidden
    obu_type = gb.get_bits(4)
    has_extension = gb.get_bit()
    has_length = gb.get_bit()
    gb.get_bit()  # reserved
    temporal_id = spatial_id = 0
    if has_extension:
        temporal_id = gb.get_bits(3)
        spatial_id = gb.get_bits(2)
        gb.get_bits(3)
    if has_length:
        length = gb.get_uleb128()
        payload_start = gb.byte_position()
        obu_end = payload_start + length
        if obu_end > len(data):
            raise ParseError("obu length")
    else:
        payload_start = gb.byte_position()
        obu_end = len(data)
    if gb.error:
        raise ParseError("obu header")

    # skip OBUs not in the selected temporal/spatial layer
    # (dav1d obu.c:1246-1254)
    if obu_type not in (h.OBU_SEQ_HDR, h.OBU_TD) and has_extension and \
            st.operating_point_idc:
        in_t = (st.operating_point_idc >> temporal_id) & 1
        in_s = (st.operating_point_idc >> (spatial_id + 8)) & 1
        if not in_t or not in_s:
            return obu_end

    gb = GetBits(data, payload_start, obu_end)

    if obu_type == h.OBU_SEQ_HDR:
        st.seq_hdr = parse_seq_hdr(gb)
        op = min(st.operating_point,
                 st.seq_hdr.num_operating_points - 1)
        st.operating_point_idc = st.seq_hdr.operating_points[op].idc
        spatial_mask = st.operating_point_idc >> 8
        st.max_spatial_id = spatial_mask.bit_length() - 1 \
            if spatial_mask else 0
    elif obu_type in (h.OBU_FRAME_HDR, h.OBU_FRAME,
                      h.OBU_REDUNDANT_FRAME_HDR):
        if obu_type == h.OBU_REDUNDANT_FRAME_HDR and st.frame_hdr:
            return obu_end
        if st.seq_hdr is None:
            raise ParseError("no seq hdr")
        st.frame_hdr = h.FrameHeader()
        st.frame_hdr.temporal_id = temporal_id
        st.frame_hdr.spatial_id = spatial_id
        parse_frame_hdr(st, gb)
        st.tiles = []
        st.n_tiles = 0
        if st.frame_hdr.show_existing_frame:
            st.frame_ready = True
            return obu_end
        if obu_type == h.OBU_FRAME:
            gb.bytealign()
            _parse_tile_group(st, gb, obu_end)
    elif obu_type == h.OBU_TILE_GRP:
        if st.frame_hdr is None:
            raise ParseError("tile group without frame hdr")
        _parse_tile_group(st, gb, obu_end)
    elif obu_type == h.OBU_METADATA:
        _parse_metadata(st, gb, data, payload_start, obu_end)
    elif obu_type == h.OBU_TD:
        st.new_temporal_unit = True
    elif obu_type == h.OBU_PADDING:
        pass
    # unknown obu types are skipped

    return obu_end


# metadata_type values (AV1 spec 6.7.1 / dav1d ObuMetaType)
_META_HDR_CLL = 1
_META_HDR_MDCV = 2
_META_SCALABILITY = 3
_META_ITUT_T35 = 4
_META_TIMECODE = 5


def _parse_metadata(st: ObuState, gb: GetBits, data, start, end):
    """dav1d obu.c:1400-1546: HDR CLL, HDR MDCV, ITU-T T.35."""
    meta_type = gb.get_uleb128()
    if gb.error:
        raise ParseError("metadata type")
    if meta_type == _META_HDR_CLL:
        max_cll = gb.get_bits(16)
        max_fall = gb.get_bits(16)
        st.content_light = (max_cll, max_fall)
    elif meta_type == _META_HDR_MDCV:
        primaries = [(gb.get_bits(16), gb.get_bits(16)) for _ in range(3)]
        white_point = (gb.get_bits(16), gb.get_bits(16))
        st.mastering_display = dict(
            primaries=primaries, white_point=white_point,
            max_luminance=gb.get_bits(32), min_luminance=gb.get_bits(32))
    elif meta_type == _META_ITUT_T35:
        pos = gb.byte_position()
        payload = data[pos:end]
        # strip trailing_zero_bit bytes then the trailing_one_bit byte
        n = len(payload)
        while n > 0 and payload[n - 1] == 0:
            n -= 1
        n -= 1
        if n < 1:
            return
        country_code = payload[0]
        off = 1
        ext = 0
        if country_code == 0xFF and n >= 2:
            ext = payload[1]
            off = 2
        st.itut_t35.append(dict(country_code=country_code,
                                country_code_extension_byte=ext,
                                payload=bytes(payload[off:n])))
    # scalability/timecode/private types are skipped


def _parse_tile_group(st: ObuState, gb: GetBits, obu_end: int):
    hdr = st.frame_hdr
    n_tiles = hdr.tiling.cols * hdr.tiling.rows
    have_tile_pos = gb.get_bit() if n_tiles > 1 else 0
    if have_tile_pos:
        n_bits = hdr.tiling.log2_cols + hdr.tiling.log2_rows
        start = gb.get_bits(n_bits)
        end = gb.get_bits(n_bits)
    else:
        start, end = 0, n_tiles - 1
    gb.bytealign()
    payload = bytes(gb.data[gb.pos:obu_end])
    st.tiles.append(TileGroup(payload, start, end))
    st.n_tiles += 1 + end - start
    if st.n_tiles >= n_tiles:
        st.frame_ready = True
