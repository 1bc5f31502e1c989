"""The in-loop filters' share of their roofline, in %: the least time of
the filter chains run in the profile stretch (each plane of each frame,
as the decoded pictures have them, read once and written once at the
card's published bandwidth, harness.yardstick) over the device time of
every kernel launched inside the filters' annotation.

The annotation wraps the decoder's call into its filter layer
(harness.trace.layer_spans). Where the configuration codes filters
(``inloop_filters``) and the annotation saw no call, or the card ran
kernels but none inside it, the filters run somewhere the annotation does
not reach, and the reader raises rather than report nothing."""
from harness.record import all_pictures
from harness.yardstick import filters_least_s


def read(rec):
    p = rec.profile
    if p is None:
        return None
    coded = rec.cell.config.get("inloop_filters")
    if coded and (not p.filters_calls or
                  (p.kernels and p.filters_kernel_s <= 0)):
        raise RuntimeError(
            f"the stream codes {', '.join(coded)}, but the profile saw "
            f"{p.filters_calls} filter calls holding "
            f"{p.filters_kernel_s} s of {p.kernels} kernels: the filters "
            "no longer run inside the decoder call that the benchmark "
            "annotates")
    if not p.filters_calls or p.filters_kernel_s <= 0:
        return None
    least = [filters_least_s([pl.shape for pl in pic.planes], pic.bitdepth,
                             rec.device_name)
             for pic in all_pictures(rec.profile_stretch)]
    if not least or None in least:
        return None
    return (100.0 * sum(least) / len(least) * p.filters_calls /
            p.filters_kernel_s)
