"""Share of the profile stretch in which no operation (kernel, copy or
set) ran on the card, in %."""


def read(rec):
    p = rec.profile
    if p is None or p.busy_s <= 0 or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
