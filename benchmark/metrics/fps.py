"""Decoded frames a second: every picture returned in the window, over
the time from the window's start to the last of them."""


def read(rec):
    pics = rec.pictures()
    if not pics:
        return None
    return len(pics) / sum(
        max((p.t for p in s.in_window()), default=s.t0) - s.t0
        for s in rec.stretches)
