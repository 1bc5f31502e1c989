#!/usr/bin/env python
"""Write each configuration's stream pool, and the expected pictures'
hashes beside each stream, into benchmark/pools/<config>/.

    JAX_PLATFORMS=cpu python benchmark/tools/make_pools.py [--config NAME]
        [--jobs N] [--configs DIR]

Run offline on a CPU, from the repo root. For every seed of a
configuration's ``pool.seeds`` it writes ``<seed>.ivf`` with the repo's
stream writer (``tests/test_e2e_inter.build_stream``) at the
configuration's ``coding`` parameters, then decodes it with the JAX
package's host reference path (``Settings(use_tpu_inter=False,
use_tpu_filters=False)``), with film grain and without, and writes
``<seed>.json``: the md5 of each visible plane of each picture (the bytes
dav1d's md5 muxer hashes: 8-bit samples, or 16-bit little-endian above 8
bits) and the md5 of the whole stream as the md5 muxer prints it.

This script alone in benchmark/ may import the JAX package: the stream
writer and the reference decode live there, and no run imports this file
(benchmark/tests/test_benchmark_run.py checks that no module run.py
reaches imports it). What it writes is data, committed, and read by the
run.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor, as_completed
from multiprocessing import get_context

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIGS = os.path.join(ROOT, "benchmark", "configs")


def coding_args(coding: dict) -> dict:
    """The writer's parameters from their JSON form: the loop filter and
    restoration levels and the grain's points as the tuples the writer
    was given in bench.E2E_CONFIGS, so the same seed writes the same
    bytes."""
    cfg = dict(coding)
    for k in ("lf", "lr"):
        if k in cfg:
            cfg[k] = tuple(cfg[k])
    if "fg" in cfg:
        fg = dict(cfg["fg"])
        if "y_points" in fg:
            fg["y_points"] = [tuple(p) for p in fg["y_points"]]
        cfg["fg"] = fg
    return cfg


def reference_hashes(data: bytes, grain: bool):
    """([[md5 of each plane] for each picture], md5 of the stream) from
    the JAX package's host reference decode."""
    import numpy as np
    import dav1d_mirror_tpu.api as japi
    from dav1d_mirror_tpu.host.ivf import parse_ivf
    _, _, _, frames = parse_ivf(data)
    dec = japi.Decoder(japi.Settings(use_tpu_inter=False,
                                     use_tpu_filters=False,
                                     apply_grain=grain))
    whole = hashlib.md5()
    pics = []
    for fr in frames:
        dec.send_data(fr.data)
        while (pic := dec.get_picture()) is not None:
            dt = np.uint8 if pic.bitdepth == 8 else np.dtype("<u2")
            planes = [np.ascontiguousarray(p.astype(dt)).tobytes()
                      for p in pic.planes]
            for b in planes:
                whole.update(b)
            pics.append([hashlib.md5(b).hexdigest() for b in planes])
    return pics, whole.hexdigest()


def _setup(configs: str, config_name: str) -> dict:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    for path in (ROOT, os.path.join(ROOT, "tests")):
        if path not in sys.path:
            sys.path.insert(0, path)
    with open(os.path.join(configs, f"{config_name}.json")) as f:
        config = json.load(f)
    if config["writer"] != "inter":
        raise ValueError(f"unknown writer {config['writer']!r}")
    return config


def _ivf_path(config: dict, seed: int) -> str:
    return os.path.join(ROOT, config["pool"]["dir"], f"{seed}.ivf")


def write_stream(config_name: str, seed: int, configs: str = CONFIGS) -> str:
    """Write one pool stream; returns a report line."""
    config = _setup(configs, config_name)
    from test_e2e_inter import build_stream
    t0 = time.time()
    _, data, n_frames = build_stream(coding_args(config["coding"]),
                                     seed=seed)
    if n_frames != config["frames_per_stream"]:
        raise RuntimeError(f"{config_name} seed {seed}: {n_frames} frames")
    os.makedirs(os.path.dirname(_ivf_path(config, seed)), exist_ok=True)
    with open(_ivf_path(config, seed), "wb") as f:
        f.write(data)
    return (f"{config_name} seed {seed}: {len(data)} bytes, {n_frames} "
            f"frames, {time.time() - t0:.0f} s")


def decode_stream(config_name: str, seed: int, grain: bool,
                  configs: str = CONFIGS):
    """The reference hashes of one written stream, with film grain or
    without."""
    config = _setup(configs, config_name)
    with open(_ivf_path(config, seed), "rb") as f:
        data = f.read()
    pics, whole = reference_hashes(data, grain)
    if len(pics) != config["frames_per_stream"]:
        raise RuntimeError(f"{config_name} seed {seed}: "
                           f"{len(pics)} pictures")
    return pics, whole


def write_side(config_name: str, seed: int, decoded: dict,
               configs: str = CONFIGS) -> str:
    """Write ``<seed>.json`` from the decodes of the stream (``decoded``:
    grain flag -> (pictures' plane hashes, stream md5))."""
    config = _setup(configs, config_name)
    with open(_ivf_path(config, seed), "rb") as f:
        data = f.read()
    expected, stream_md5 = {}, {}
    for grain, (pics, whole) in decoded.items():
        key = "grain" if grain else "nograin"
        expected[key], stream_md5[key] = pics, whole
    if "fg" not in config["coding"]:
        # no frame carries grain: the output is the same either way
        expected["nograin"] = expected["grain"]
        stream_md5["nograin"] = stream_md5["grain"]
    side = {"seed": seed, "config": config_name,
            "file_md5": hashlib.md5(data).hexdigest(),
            "bytes": len(data), "pictures": config["frames_per_stream"],
            "stream_md5": stream_md5, "planes_md5": expected,
            "reference": "dav1d_mirror_tpu host reference path "
                         "(use_tpu_inter=False, use_tpu_filters=False)"}
    out = _ivf_path(config, seed)[:-4] + ".json"
    with open(out, "w") as f:
        json.dump(side, f, indent=1)
        f.write("\n")
    return f"{config_name} seed {seed}: stream md5 {stream_md5}"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", action="append",
                    help="a configuration's name (default: every one)")
    ap.add_argument("--configs", default=CONFIGS,
                    help="the configurations' directory (default: "
                         "benchmark/configs)")
    ap.add_argument("--jobs", type=int, default=2,
                    help="worker processes (each holds a 1080p decode)")
    opts = ap.parse_args()
    names = opts.config or sorted(
        f[:-5] for f in os.listdir(opts.configs) if f.endswith(".json"))
    streams = []
    for name in names:
        with open(os.path.join(opts.configs, f"{name}.json")) as f:
            config = json.load(f)
        grains = (True, False) if "fg" in config["coding"] else (True,)
        streams += [(name, s, grains) for s in config["pool"]["seeds"]]
    want = {(n, s): len(gs) for n, s, gs in streams}
    with ProcessPoolExecutor(opts.jobs,
                             mp_context=get_context("spawn")) as pool:
        for fut in [pool.submit(write_stream, n, s, opts.configs)
                    for n, s, _ in streams]:
            print(fut.result(), flush=True)
        # the longest decodes first; a stream's hashes are written as
        # soon as all its decodes are done
        jobs = {pool.submit(decode_stream, n, s, g, opts.configs):
                (n, s, g) for n, s, gs in
                sorted(streams, key=lambda x: -len(x[2])) for g in gs}
        decoded = {(n, s): {} for n, s, _ in streams}
        for fut in as_completed(jobs):
            n, s, g = jobs[fut]
            decoded[(n, s)][g] = fut.result()
            if len(decoded[(n, s)]) == want[(n, s)]:
                print(write_side(n, s, decoded[(n, s)], opts.configs),
                      flush=True)


if __name__ == "__main__":
    main()
