"""95th percentile (nearest rank), over every picture of the traced
window, of the time from the send of its temporal unit to the
get_picture that returned it, in milliseconds."""
import math


def read(rec):
    lat = sorted(p.latency_s for p in rec.pictures()
                 if not math.isnan(p.latency_s))
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
