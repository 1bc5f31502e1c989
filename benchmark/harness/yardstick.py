"""The yardstick: the card's published peaks and the bytes a frame's
filters must move at the least.

The count depends only on the decoded picture's planes and bit depth,
never on the program's work lists, so it reads the same work whatever
implements the filters.
"""
from __future__ import annotations

# published HBM bandwidth in bytes/s (NVIDIA's H100 SXM data sheet:
# 3.35 TB/s at the 700 W limit), by torch.cuda.get_device_name()
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def frame_bytes(plane_shapes, bitdepth: int) -> int:
    """Bytes of one frame's planes, each given as its (height, width), at
    the stream's sample width (1 byte at 8 bits, 2 above)."""
    per = 1 if bitdepth == 8 else 2
    return per * sum(h * w for h, w in plane_shapes)


def filters_least_s(plane_shapes, bitdepth: int,
                    device_name: str) -> float | None:
    """Least time of one frame's in-loop filter chain on the card: each
    plane read once and written once at the peak bandwidth. None for a
    card whose peak is not in the table."""
    peak = PEAK_BYTES_PER_S.get(device_name)
    if peak is None:
        return None
    return 2 * frame_bytes(plane_shapes, bitdepth) / peak
