# Copied from dav1d_mirror_tpu/data/tables.py.
"""AV1 spec-constant tables (normative data, identical in every conformant
decoder), packed into spec_tables.npz by tools_dev/extract_tables.sh.

Includes: default CDFs (per qindex category), scan orders, dequant tables,
quantizer matrices, subpel/warp/resize filter coefficients, intra smooth
weights & directional derivatives, CDEF directions, SGR params, film-grain
gaussian sequence, and the block-geometry LUTs.
"""
from __future__ import annotations

import os

import numpy as np

_NPZ_PATH = os.path.join(os.path.dirname(__file__), "spec_tables.npz")


class _Tables:
    def __init__(self):
        self._npz = None
        self._cache = {}

    def _load(self):
        if self._npz is None:
            self._npz = np.load(_NPZ_PATH)
        return self._npz

    def __getitem__(self, name: str) -> np.ndarray:
        # npz members are decompressed from the archive on EVERY access;
        # memoize (tables are treated as read-only by all callers — CDF
        # users copy via np.array/new_cdf_context before adapting).
        a = self._cache.get(name)
        if a is None:
            a = self._load()[name]
            a.setflags(write=False)
            self._cache[name] = a
        return a

    def __contains__(self, name):
        return name in self._load().files

    def keys(self):
        return self._load().files

    # convenience accessors
    @property
    def scans(self):
        """scan order per tx size: list of 19 uint16 arrays (len sw*sh)."""
        return [self[f"scan.{t}"] for t in range(19)]

    def qm(self, qmi: int, is_chroma: int, tx: int) -> np.ndarray | None:
        if qmi == 15:
            return None
        return self[f"qm.{qmi}.{int(is_chroma)}.{tx}"]


TABLES = _Tables()


class CdfContext:
    """Mutable per-tile CDF state (the analogue of dav1d's CdfContext).

    Attributes hold numpy uint16 arrays; symbol decode adapts them in place.
    """
    __slots__ = ("m", "coef", "mv", "dmv", "kfym")

    def copy(self) -> "CdfContext":
        c = CdfContext.__new__(CdfContext)
        c.m = {k: v.copy() for k, v in self.m.items()}
        c.coef = {k: v.copy() for k, v in self.coef.items()}
        c.mv = {k: v.copy() for k, v in self.mv.items()}
        c.dmv = {k: v.copy() for k, v in self.dmv.items()}
        c.kfym = self.kfym.copy()
        return c


def _mv_component() -> dict:
    pre = "cdf.mv_comp."
    return {k[len(pre):]: np.array(TABLES[k]) for k in TABLES.keys()
            if k.startswith(pre)}


def new_cdf_context(qcat: int) -> CdfContext:
    """Fresh default CDF context for a quantizer category 0-3
    (dav1d src/cdf.c:4084-4102; qcat from qidx thresholds)."""
    c = CdfContext.__new__(CdfContext)
    c.m = {}
    for k in TABLES.keys():
        if k.startswith("cdf.m."):
            c.m[k[6:]] = np.array(TABLES[k])
    pre = f"cdf.coef{qcat}."
    c.coef = {k[len(pre):]: np.array(TABLES[k]) for k in TABLES.keys()
              if k.startswith(pre)}
    mvc = _mv_component()
    c.mv = {"joint": np.array(TABLES["cdf.mv_joint"])}
    c.dmv = {"joint": np.array(TABLES["cdf.mv_joint"])}
    for comp in range(2):
        for k, v in mvc.items():
            c.mv[f"comp{comp}.{k}"] = v.copy()
            c.dmv[f"comp{comp}.{k}"] = v.copy()
    c.kfym = np.array(TABLES["cdf.kf_y_mode"])
    return c


# (name, count-slot index) pairs for dav1d_cdf_thread_update (cdf.c:3948):
# the saved context is a copy of the frame's input CDFs with the listed
# fields replaced by the adapted values and their adaptation counters
# zeroed. Unlisted fields (kfym; mv/y_mode etc. on key frames) keep the
# input values.
_UPD_M_COMMON = [
    ("use_filter_intra", 1), ("filter_intra", 4), ("angle_delta", 6),
    ("txtp_intra1", 6), ("txtp_intra2", 4), ("skip", 1), ("seg_id", 7),
    ("cfl_sign", 7), ("cfl_alpha", 15), ("restore_wiener", 1),
    ("restore_sgrproj", 1), ("restore_switchable", 2), ("delta_q", 3),
    ("delta_lf", 3), ("pal_y", 1), ("pal_uv", 1), ("pal_sz", 6),
    ("txpart", 1), ("txtp_inter1", 15), ("txtp_inter2", 11),
    ("txtp_inter3", 1),
]
_UPD_COEF = [
    ("skip", 1), ("eob_bin_16", 4), ("eob_bin_32", 5), ("eob_bin_64", 6),
    ("eob_bin_128", 7), ("eob_bin_256", 8), ("eob_bin_512", 9),
    ("eob_bin_1024", 10), ("eob_hi_bit", 1), ("eob_base_tok", 2),
    ("base_tok", 3), ("dc_sign", 1), ("br_tok", 3),
]
_UPD_M_INTER = [
    ("skip_mode", 1), ("y_mode", 12), ("filter", 2), ("newmv_mode", 1),
    ("globalmv_mode", 1), ("refmv_mode", 1), ("drl_bit", 1),
    ("comp_inter_mode", 7), ("intra", 1), ("comp", 1), ("comp_dir", 1),
    ("jnt_comp", 1), ("mask_comp", 1), ("wedge_comp", 1), ("wedge_idx", 15),
    ("ref", 1), ("comp_fwd_ref", 1), ("comp_bwd_ref", 1),
    ("comp_uni_ref", 1), ("seg_pred", 1), ("interintra_wedge", 1),
    ("interintra_mode", 3), ("motion_mode", 2), ("obmc", 1),
]
_UPD_MV = [("classes", 10), ("class0", 1), ("classN", 1), ("sign", 1)]
_UPD_MV_FP = [("class0_fp", 3), ("classN_fp", 3), ("class0_hp", 1),
              ("classN_hp", 1)]


def cdf_thread_update(cdf_in: CdfContext, adapted: CdfContext,
                      key_or_intra: bool) -> CdfContext:
    """dav1d cdf.c dav1d_cdf_thread_update:3948. Returns the context to be
    saved into refreshed reference slots."""
    out = cdf_in.copy()

    def cp(dst, src, cnt):
        dst[...] = src
        dst[..., cnt] = 0

    for name, cnt in _UPD_M_COMMON:
        cp(out.m[name], adapted.m[name], cnt)
    for name, cnt in _UPD_COEF:
        cp(out.coef[name], adapted.coef[name], cnt)
    # per-index count positions
    cp(out.m["uv_mode"][0], adapted.m["uv_mode"][0], 12)
    cp(out.m["uv_mode"][1], adapted.m["uv_mode"][1], 13)
    cp(out.m["txsz"][0], adapted.m["txsz"][0], 1)
    cp(out.m["txsz"][1:], adapted.m["txsz"][1:], 2)
    pcount = TABLES["partition_type_count"]
    for bl in range(5):
        cp(out.m["partition"][bl], adapted.m["partition"][bl],
           int(pcount[bl]))
    for k in range(5):
        cp(out.m["color_map"][:, :, k], adapted.m["color_map"][:, :, k],
           k + 1)

    if key_or_intra:
        cp(out.m["intrabc"], adapted.m["intrabc"], 1)
        cp(out.dmv["joint"], adapted.dmv["joint"], 3)
        for c in range(2):
            for name, cnt in _UPD_MV:
                key = f"comp{c}.{name}"
                cp(out.dmv[key], adapted.dmv[key], cnt)
        return out

    for name, cnt in _UPD_M_INTER:
        cp(out.m[name], adapted.m[name], cnt)
    cp(out.m["interintra"][:4], adapted.m["interintra"][:4], 1)
    cp(out.mv["joint"], adapted.mv["joint"], 3)
    for c in range(2):
        for name, cnt in _UPD_MV + _UPD_MV_FP:
            key = f"comp{c}.{name}"
            cp(out.mv[key], adapted.mv[key], cnt)
    return out


def qcat_from_qidx(qidx: int) -> int:
    """Quantizer category for default coef CDF selection
    (dav1d src/cdf.c:4104-4110)."""
    if qidx <= 20:
        return 0
    if qidx <= 60:
        return 1
    if qidx <= 120:
        return 2
    return 3
