# Copied from dav1d_mirror_tpu/errors.py.
"""Shared error type (dav1d returns negative errnos, lib.c; here one
exception class raised from any depth and contained at the API boundary
— api.Decoder poisons the affected frame/slots and stays usable)."""


class DecodeError(Exception):
    """Corrupt or non-conformant input detected during decode."""
