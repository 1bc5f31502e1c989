# Copied from dav1d_mirror_tpu/host/headers.py.
"""Sequence/frame header structures (mirrors include/dav1d/headers.h subset).

Field names follow the reference's Dav1dSequenceHeader / Dav1dFrameHeader so
the parity with `src/obu.c` parsing is auditable line by line.
"""
from __future__ import annotations

from dataclasses import dataclass, field

# enums
KEY, INTER, INTRA, SWITCH = range(4)  # frame types
PIXEL_LAYOUT_I400, PIXEL_LAYOUT_I420, PIXEL_LAYOUT_I422, \
    PIXEL_LAYOUT_I444 = range(4)
ADAPTIVE = 2
PRIMARY_REF_NONE = 7
TX_4X4_ONLY, TX_LARGEST, TX_SWITCHABLE = range(3)
FILTER_8TAP_REGULAR, FILTER_8TAP_SMOOTH, FILTER_8TAP_SHARP, \
    FILTER_BILINEAR = range(4)
FILTER_SWITCHABLE = 4
RESTORATION_NONE, RESTORATION_SWITCHABLE, RESTORATION_WIENER, \
    RESTORATION_SGRPROJ = range(4)
WM_TYPE_IDENTITY, WM_TYPE_TRANSLATION, WM_TYPE_ROT_ZOOM, \
    WM_TYPE_AFFINE = range(4)
MAX_SEGMENTS = 8
MAX_TILE_COLS = 64
MAX_TILE_ROWS = 64

OBU_SEQ_HDR = 1
OBU_TD = 2
OBU_FRAME_HDR = 3
OBU_TILE_GRP = 4
OBU_METADATA = 5
OBU_FRAME = 6
OBU_REDUNDANT_FRAME_HDR = 7
OBU_PADDING = 15


def is_key_or_intra(hdr) -> bool:
    return hdr.frame_type in (KEY, INTRA)


def is_inter_or_switch(hdr) -> bool:
    return hdr.frame_type in (INTER, SWITCH)


@dataclass
class OperatingPoint:
    idc: int = 0
    major_level: int = 2
    minor_level: int = 0
    initial_display_delay: int = 10
    tier: int = 0
    decoder_model_param_present: int = 0
    display_model_param_present: int = 0


@dataclass
class SequenceHeader:
    profile: int = 0
    still_picture: int = 0
    reduced_still_picture_header: int = 0
    timing_info_present: int = 0
    num_units_in_tick: int = 0
    time_scale: int = 0
    equal_picture_interval: int = 0
    num_ticks_per_picture: int = 0
    decoder_model_info_present: int = 0
    encoder_decoder_buffer_delay_length: int = 0
    num_units_in_decoding_tick: int = 0
    buffer_removal_delay_length: int = 0
    frame_presentation_delay_length: int = 0
    display_model_info_present: int = 0
    num_operating_points: int = 1
    operating_points: list = field(default_factory=lambda: [OperatingPoint()])
    max_width: int = 0
    max_height: int = 0
    width_n_bits: int = 16
    height_n_bits: int = 16
    frame_id_numbers_present: int = 0
    delta_frame_id_n_bits: int = 0
    frame_id_n_bits: int = 0
    sb128: int = 0
    filter_intra: int = 0
    intra_edge_filter: int = 0
    inter_intra: int = 0
    masked_compound: int = 0
    warped_motion: int = 0
    dual_filter: int = 0
    order_hint: int = 0
    jnt_comp: int = 0
    ref_frame_mvs: int = 0
    screen_content_tools: int = 0
    force_integer_mv: int = 2
    order_hint_n_bits: int = 0
    super_res: int = 0
    cdef: int = 0
    restoration: int = 0
    hbd: int = 0
    monochrome: int = 0
    color_description_present: int = 0
    pri: int = 2
    trc: int = 2
    mtrx: int = 2
    color_range: int = 0
    layout: int = PIXEL_LAYOUT_I420
    ss_hor: int = 1
    ss_ver: int = 1
    chr: int = 0
    separate_uv_delta_q: int = 0
    film_grain_present: int = 0

    @property
    def bitdepth(self) -> int:
        return 8 + 2 * self.hbd

    @property
    def bitdepth_max(self) -> int:
        return (1 << self.bitdepth) - 1


@dataclass
class SegmentationData:
    delta_q: int = 0
    delta_lf_y_v: int = 0
    delta_lf_y_h: int = 0
    delta_lf_u: int = 0
    delta_lf_v: int = 0
    ref: int = -1
    skip: int = 0
    globalmv: int = 0


@dataclass
class SegmentationDataSet:
    d: list = field(default_factory=lambda: [SegmentationData()
                                             for _ in range(MAX_SEGMENTS)])
    preskip: int = 0
    last_active_segid: int = -1


@dataclass
class LoopfilterModeRefDeltas:
    mode_delta: list = field(default_factory=lambda: [0, 0])
    ref_delta: list = field(default_factory=lambda: [1, 0, 0, 0, -1, 0,
                                                     -1, -1])


@dataclass
class FilmGrainData:
    seed: int = 0
    num_y_points: int = 0
    y_points: list = field(default_factory=list)  # [(x, y)]
    chroma_scaling_from_luma: int = 0
    num_uv_points: list = field(default_factory=lambda: [0, 0])
    uv_points: list = field(default_factory=lambda: [[], []])
    scaling_shift: int = 8
    ar_coeff_lag: int = 0
    ar_coeffs_y: list = field(default_factory=lambda: [0] * 24)
    ar_coeffs_uv: list = field(default_factory=lambda: [[0] * 28, [0] * 28])
    ar_coeff_shift: int = 6
    grain_scale_shift: int = 0
    uv_mult: list = field(default_factory=lambda: [0, 0])
    uv_luma_mult: list = field(default_factory=lambda: [0, 0])
    uv_offset: list = field(default_factory=lambda: [0, 0])
    overlap_flag: int = 0
    clip_to_restricted_range: int = 0


@dataclass
class WarpedMotionParams:
    type: int = WM_TYPE_IDENTITY
    matrix: list = field(default_factory=lambda: [0, 0, 1 << 16, 0, 0,
                                                  1 << 16])


@dataclass
class Tiling:
    uniform: int = 1
    n_bytes: int = 0
    min_log2_cols: int = 0
    max_log2_cols: int = 0
    log2_cols: int = 0
    cols: int = 1
    min_log2_rows: int = 0
    max_log2_rows: int = 0
    log2_rows: int = 0
    rows: int = 1
    col_start_sb: list = field(default_factory=lambda: [0] * 65)
    row_start_sb: list = field(default_factory=lambda: [0] * 65)
    update: int = 0


@dataclass
class FrameHeader:
    frame_type: int = KEY
    width: list = field(default_factory=lambda: [0, 0])  # [post-sr, pre-sr]
    height: int = 0
    frame_offset: int = 0
    temporal_id: int = 0
    spatial_id: int = 0
    show_existing_frame: int = 0
    existing_frame_idx: int = 0
    frame_id: int = 0
    frame_presentation_delay: int = 0
    show_frame: int = 1
    showable_frame: int = 0
    error_resilient_mode: int = 0
    disable_cdf_update: int = 0
    allow_screen_content_tools: int = 0
    force_integer_mv: int = 1
    frame_size_override: int = 0
    primary_ref_frame: int = PRIMARY_REF_NONE
    buffer_removal_time_present: int = 0
    refresh_frame_flags: int = 0xFF
    render_width: int = 0
    render_height: int = 0
    super_res_enabled: int = 0
    super_res_width_scale_denominator: int = 8
    have_render_size: int = 0
    allow_intrabc: int = 0
    frame_ref_short_signaling: int = 0
    refidx: list = field(default_factory=lambda: [-1] * 7)
    hp: int = 0
    subpel_filter_mode: int = FILTER_8TAP_REGULAR
    switchable_motion_mode: int = 0
    use_ref_frame_mvs: int = 0
    refresh_context: int = 1
    tiling: Tiling = field(default_factory=Tiling)
    # quant
    quant_yac: int = 0
    quant_ydc_delta: int = 0
    quant_udc_delta: int = 0
    quant_uac_delta: int = 0
    quant_vdc_delta: int = 0
    quant_vac_delta: int = 0
    quant_qm: int = 0
    quant_qm_y: int = 15
    quant_qm_u: int = 15
    quant_qm_v: int = 15
    # segmentation
    segmentation_enabled: int = 0
    segmentation_update_map: int = 0
    segmentation_temporal: int = 0
    segmentation_update_data: int = 0
    seg_data: SegmentationDataSet = field(
        default_factory=SegmentationDataSet)
    segmentation_qidx: list = field(default_factory=lambda: [0] * 8)
    segmentation_lossless: list = field(default_factory=lambda: [0] * 8)
    all_lossless: int = 0
    # delta q/lf
    delta_q_present: int = 0
    delta_q_res_log2: int = 0
    delta_lf_present: int = 0
    delta_lf_res_log2: int = 0
    delta_lf_multi: int = 0
    # loopfilter
    loopfilter_level_y: list = field(default_factory=lambda: [0, 0])
    loopfilter_level_u: int = 0
    loopfilter_level_v: int = 0
    loopfilter_sharpness: int = 0
    loopfilter_mode_ref_delta_enabled: int = 1
    loopfilter_mode_ref_delta_update: int = 0
    loopfilter_mode_ref_deltas: LoopfilterModeRefDeltas = field(
        default_factory=LoopfilterModeRefDeltas)
    # cdef
    cdef_damping: int = 3
    cdef_n_bits: int = 0
    cdef_y_strength: list = field(default_factory=lambda: [0] * 8)
    cdef_uv_strength: list = field(default_factory=lambda: [0] * 8)
    # restoration
    restoration_type: list = field(
        default_factory=lambda: [RESTORATION_NONE] * 3)
    restoration_unit_size: list = field(default_factory=lambda: [8, 8])
    # misc
    txfm_mode: int = TX_LARGEST
    switchable_comp_refs: int = 0
    skip_mode_allowed: int = 0
    skip_mode_enabled: int = 0
    skip_mode_refs: list = field(default_factory=lambda: [0, 0])
    warp_motion: int = 0
    reduced_txtp_set: int = 0
    gmv: list = field(default_factory=lambda: [WarpedMotionParams()
                                               for _ in range(7)])
    film_grain_present: int = 0
    film_grain_update: int = 1
    film_grain_data: FilmGrainData = field(default_factory=FilmGrainData)
