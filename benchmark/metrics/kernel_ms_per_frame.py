"""Summed device time of every kernel a picture, in milliseconds, over
the profile stretch."""
from harness.record import profile_per_frame


def read(rec):
    if rec.profile is None or not rec.profile.kernels:
        return None
    return profile_per_frame(rec, rec.profile.kernel_s * 1e3)
