"""Seconds from the run's start to the window's: importing, building or
loading the kernels and the native library, reading the pool, opening the
decoder and decoding the first frames of a pool stream to warm up."""


def read(rec):
    return rec.setup_s
