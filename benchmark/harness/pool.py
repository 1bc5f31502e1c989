"""A configuration's stream pool: the committed IVF streams, each split
into temporal units, with the expected planes' hashes beside it, and the
order a seed decodes them in."""
from __future__ import annotations

import json
import os
import random
import struct
from dataclasses import dataclass


@dataclass
class Stream:
    seed: int
    units: list          # the temporal units' bytes, in order
    # {"grain": [[md5 of each plane] a picture], "nograin": [...]}
    planes_md5: dict


def ivf_units(data: bytes) -> list:
    """The frame payloads (temporal units) of an IVF file."""
    if data[:4] != b"DKIF":
        raise ValueError("not an IVF file")
    pos = struct.unpack_from("<H", data, 6)[0]
    units = []
    while pos + 12 <= len(data):
        size = struct.unpack_from("<I", data, pos)[0]
        pos += 12
        if pos + size > len(data):
            raise ValueError("truncated IVF frame")
        units.append(bytes(data[pos:pos + size]))
        pos += size
    return units


def load_pool(root: str, config: dict) -> list:
    """Every stream of the configuration's pool, in ``pool.seeds`` order."""
    out = []
    for seed in config["pool"]["seeds"]:
        base = os.path.join(root, config["pool"]["dir"], str(seed))
        with open(base + ".ivf", "rb") as f:
            units = ivf_units(f.read())
        with open(base + ".json") as f:
            side = json.load(f)
        if len(units) != config["frames_per_stream"]:
            raise ValueError(f"{base}.ivf: {len(units)} temporal units")
        out.append(Stream(seed, units, side["planes_md5"]))
    return out


def stream_order(n_streams: int, seed: int):
    """Pool indices in the order a run with `seed` decodes them: a fresh
    seeded shuffle of the whole pool each pass, so every pass decodes
    every stream once."""
    rng = random.Random(seed)
    while True:
        order = list(range(n_streams))
        rng.shuffle(order)
        yield from order
