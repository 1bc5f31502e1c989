# Copied from dav1d_mirror_tpu/ops/itx_meta.py.
"""Static metadata for the inverse-transform surface.

Reference parity: dav1d `src/itx_tmpl.c:142-160` (per-size shifts and allowed
type sets), `src/levels.h:44-99` (TxfmSize/RectTxfmSize/TxfmType enums).
"""
from __future__ import annotations

# TxfmSize / RectTxfmSize enum (dav1d src/levels.h:44-77)
TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64 = range(5)
(RTX_4X8, RTX_8X4, RTX_8X16, RTX_16X8, RTX_16X32, RTX_32X16, RTX_32X64,
 RTX_64X32, RTX_4X16, RTX_16X4, RTX_8X32, RTX_32X8, RTX_16X64,
 RTX_64X16) = range(5, 19)
N_RECT_TX_SIZES = 19

# TxfmType enum (dav1d src/levels.h:80-99)
(DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST,
 FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT,
 V_ADST, H_ADST, V_FLIPADST, H_FLIPADST) = range(16)
N_TX_TYPES = 16
WHT_WHT = 16

# tx size index -> (w, h, intermediate shift); shifts per itx_tmpl.c:142-160
TX_INFO = {
    TX_4X4:    (4, 4, 0),
    TX_8X8:    (8, 8, 1),
    TX_16X16:  (16, 16, 2),
    TX_32X32:  (32, 32, 2),
    TX_64X64:  (64, 64, 2),
    RTX_4X8:   (4, 8, 0),
    RTX_8X4:   (8, 4, 0),
    RTX_8X16:  (8, 16, 1),
    RTX_16X8:  (16, 8, 1),
    RTX_16X32: (16, 32, 1),
    RTX_32X16: (32, 16, 1),
    RTX_32X64: (32, 64, 1),
    RTX_64X32: (64, 32, 1),
    RTX_4X16:  (4, 16, 1),
    RTX_16X4:  (16, 4, 1),
    RTX_8X32:  (8, 32, 2),
    RTX_32X8:  (32, 8, 2),
    RTX_16X64: (16, 64, 2),
    RTX_64X16: (64, 16, 2),
}

TX_BY_DIMS = {(w, h): tx for tx, (w, h, _) in TX_INFO.items()}

# TxfmType -> (row/horizontal 1D family, col/vertical 1D family).
# TxfmType names are (vertical, horizontal); e.g. ADST_DCT = ADST vertically,
# DCT horizontally.
TXTYPE_TO_1D = {
    DCT_DCT:           ("dct", "dct"),
    ADST_DCT:          ("dct", "adst"),
    DCT_ADST:          ("adst", "dct"),
    ADST_ADST:         ("adst", "adst"),
    FLIPADST_DCT:      ("dct", "flipadst"),
    DCT_FLIPADST:      ("flipadst", "dct"),
    FLIPADST_FLIPADST: ("flipadst", "flipadst"),
    ADST_FLIPADST:     ("flipadst", "adst"),
    FLIPADST_ADST:     ("adst", "flipadst"),
    IDTX:              ("identity", "identity"),
    V_DCT:             ("identity", "dct"),
    H_DCT:             ("dct", "identity"),
    V_ADST:            ("identity", "adst"),
    H_ADST:            ("adst", "identity"),
    V_FLIPADST:        ("identity", "flipadst"),
    H_FLIPADST:        ("flipadst", "identity"),
}


def allowed_txtypes(tx: int) -> list[int]:
    """Valid TxfmType values for a given tx size (itx_tmpl.c assign macros)."""
    w, h, _ = TX_INFO[tx]
    mx = max(w, h)
    if mx == 64:
        return [DCT_DCT]
    if mx == 32:
        return [DCT_DCT, IDTX]
    if w == 16 and h == 16:
        return [DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT,
                DCT_FLIPADST, FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST,
                IDTX, V_DCT, H_DCT]
    types = list(range(N_TX_TYPES))
    if tx == TX_4X4:
        types.append(WHT_WHT)
    return types
