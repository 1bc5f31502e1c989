"""CUDA kernels launched a picture, over the profile stretch."""
from harness.record import profile_per_frame


def read(rec):
    if rec.profile is None or not rec.profile.kernels:
        return None
    return profile_per_frame(rec, rec.profile.kernels)
