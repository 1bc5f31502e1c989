"""Milliseconds a picture in the decoder's `host-pass2` stage (its own stage
span, which synchronises the card on exit), over the traced run's stage
stretch."""
from harness.record import stage_ms_per_frame


def read(rec):
    return stage_ms_per_frame(rec, "host-pass2")
