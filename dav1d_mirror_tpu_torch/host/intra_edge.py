# Copied from dav1d_mirror_tpu/host/intra_edge.py.
"""Intra-edge availability tree (port of dav1d src/intra_edge.c semantics).

For each node of the recursive partition, precomputes EdgeFlags describing
whether a block's top-right / bottom-left neighbours are available, per
chroma layout.
"""
from __future__ import annotations

EDGE_I444_TOP_HAS_RIGHT = 1 << 0
EDGE_I422_TOP_HAS_RIGHT = 1 << 1
EDGE_I420_TOP_HAS_RIGHT = 1 << 2
EDGE_I444_LEFT_HAS_BOTTOM = 1 << 3
EDGE_I422_LEFT_HAS_BOTTOM = 1 << 4
EDGE_I420_LEFT_HAS_BOTTOM = 1 << 5
EDGE_ALL_TOP_HAS_RIGHT = 0x07
EDGE_ALL_LEFT_HAS_BOTTOM = 0x38
EDGE_ALL_TR_AND_BL = 0x3F

BL_128X128, BL_64X64, BL_32X32, BL_16X16, BL_8X8 = range(5)


class EdgeTip:
    __slots__ = ("o", "h", "v", "split")

    def __init__(self, bl, edge_flags):
        assert bl == BL_8X8
        self.o = edge_flags
        self.h = [edge_flags | EDGE_ALL_LEFT_HAS_BOTTOM,
                  edge_flags & (EDGE_ALL_LEFT_HAS_BOTTOM |
                                EDGE_I420_TOP_HAS_RIGHT)]
        self.v = [edge_flags | EDGE_ALL_TOP_HAS_RIGHT,
                  edge_flags & (EDGE_ALL_TOP_HAS_RIGHT |
                                EDGE_I420_LEFT_HAS_BOTTOM |
                                EDGE_I422_LEFT_HAS_BOTTOM)]
        self.split = [
            (edge_flags & EDGE_ALL_TOP_HAS_RIGHT) | EDGE_I422_LEFT_HAS_BOTTOM,
            edge_flags | EDGE_I444_TOP_HAS_RIGHT,
            edge_flags & (EDGE_I420_TOP_HAS_RIGHT |
                          EDGE_I420_LEFT_HAS_BOTTOM |
                          EDGE_I422_LEFT_HAS_BOTTOM),
        ]


class EdgeBranch:
    __slots__ = ("o", "h", "v", "h4", "v4", "split")

    def __init__(self, bl, edge_flags, top_has_right, left_has_bottom):
        self.o = edge_flags
        self.h = [edge_flags | EDGE_ALL_LEFT_HAS_BOTTOM,
                  edge_flags & EDGE_ALL_LEFT_HAS_BOTTOM]
        self.v = [edge_flags | EDGE_ALL_TOP_HAS_RIGHT,
                  edge_flags & EDGE_ALL_TOP_HAS_RIGHT]
        self.h4 = EDGE_ALL_LEFT_HAS_BOTTOM
        self.v4 = EDGE_ALL_TOP_HAS_RIGHT
        if bl == BL_16X16:
            self.h4 |= edge_flags & EDGE_I420_TOP_HAS_RIGHT
            self.v4 |= edge_flags & (EDGE_I420_LEFT_HAS_BOTTOM |
                                     EDGE_I422_LEFT_HAS_BOTTOM)
        self.split = []
        for n in range(4):
            thr = not (n == 3 or (n == 1 and not top_has_right))
            lhb = n == 0 or (n == 2 and left_has_bottom)
            if bl == BL_16X16:
                self.split.append(EdgeTip(
                    bl + 1,
                    (EDGE_ALL_TOP_HAS_RIGHT if thr else 0) |
                    (EDGE_ALL_LEFT_HAS_BOTTOM if lhb else 0)))
            else:
                self.split.append(EdgeBranch(
                    bl + 1,
                    (EDGE_ALL_TOP_HAS_RIGHT if thr else 0) |
                    (EDGE_ALL_LEFT_HAS_BOTTOM if lhb else 0),
                    thr, lhb))


def _root(bl):
    return EdgeBranch(bl, EDGE_ALL_TOP_HAS_RIGHT, 1, 0)


INTRA_EDGE_TREE = {BL_128X128: _root(BL_128X128), BL_64X64: _root(BL_64X64)}
