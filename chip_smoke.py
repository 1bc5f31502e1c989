#!/usr/bin/env python3
"""Smoke test of dav1d_mirror_tpu_torch on one CUDA GPU (an H100).

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout. It

1. builds the package's kernels (its ten CUDA sources: the MC H-plane
   and V-pass kernels, the translational and scaled unit MC kernels, the
   inverse transform, deblock, CDEF, and the inter tools' warp, compound
   join and OBMC blend kernels, one nvcc each, side by side;
   ``-Xptxas -v`` must show no stack frame and no spill in the last
   eight) and its native host library from the checkout's sources;
2. drives each path through ``Decoder(Settings(device="cuda"))``, each
   with the kernel launch counters set to 0 just before it and read just
   after, and asserts each stream's md5 and that every counter moved
   (the scaled MC kernel's on the super-res path; the itx and unit MC
   kernels' also in the tile-sharded decode), each unit MC kernel once
   for each program with its work (an mcurun or mcsrun record: the
   frame's put/scaled records and "t"/"s" sub-ops in one work list) and
   never as a one-entry list (the pipelined paths as their serial
   decodes), the deblock kernel once for each dbkrun record (a frame's
   planes, both passes) and the CDEF kernel once for each cdef record
   (the direction search and the filter of the frame's planes), both
   also in the tile-sharded decode (its band functions: a pass launch
   each way a plane, the direction search and a filter launch a
   plane), the warp kernel once for each warprun record (a frame's warp
   records and "w" sub-ops in one work list, at most once a frame), the
   compound join kernel once for each comprun record (a frame's comp
   records of every plane in one work list, at most once a frame; also
   in the tile-sharded decode, a list a frame) and the OBMC kernel once
   for each obmcrun record (a phase's obmc records of every plane, at
   most twice a frame) (each path's launches printed):
   config 2, the 9-frame 1080p 8-bit inter + deblock + CDEF stream
   (bench_cache/e2e_1080p_inter_cdef_727de0883e7e.ivf); config 3, the
   5-frame 1080p 10-bit stream with Wiener loop restoration and film
   grain (bench_cache/e2e_1080p_10bit_grain_lr_6d42abf87190.ivf), with
   grain and again without it (an LR fault and a grain fault give
   different hashes); the tools path, the 5-frame 1080p stream of
   config 2's parameters with compound references, local and global
   warp, OBMC and inter-intra (tests/streams_torch/
   e2e_1080p_inter_tools.ivf), where comp, warp and obmc ops and
   inter-intra blocks must run; config 4, the 3-frame 4K 10-bit stream
   with 2x2 tiles (bench_cache/e2e_4k_10bit_multitile_479aaf4a51e3.ivf);
   the super-res path, the 5-frame 1080p stream of config 2's parameters
   whose frames switch super-res denominators (16, 16, 12, none, 9) with
   compound, OBMC and inter-intra blocks (tests/streams_torch/
   e2e_1080p_superres.ivf), where scaled and sres ops and scaled compound
   sides and OBMC laps must run; the Professional path, the 5-frame
   1080p 12-bit 4:2:2 stream of the tools path's coding with loop
   restoration (switchable, self-guided and Wiener) and chroma film grain
   (tests/streams_torch/e2e_1080p_422_12bit.ivf), and the High path, the
   5-frame 1080p 10-bit 4:4:4 stream of the tools path's coding with
   palette blocks in inter frames (tests/streams_torch/
   e2e_1080p_444_10bit.ivf), each decoded twice to its md5, the
   Professional one also without grain and, without grain, through
   ``Decoder.apply_grain``. Each path also runs a staged pass for
   its stage split (the tools and super-res streams' hash a second
   time). Config 3 is decoded once more without grain, each picture then
   grained by ``Decoder.apply_grain``. The engine path is config 2 with
   ``Settings(intra_engine=True)``, decoded three times (plain, staged,
   and counting the eager ops of each frame's wave scan): the keyframe
   must run the device intra engine's own program and every inter frame
   its scan inside the frame's program, with no host pass 2. Small
   streams are decoded on the card as well: two corpus streams with
   self-guided and switchable restoration, five with compound, warp and
   OBMC blocks and one with super-res (tests/streams, against
   tests/streams/md5.txt), a lossless one (tests/streams_torch/
   lossless_128x64.ivf), six intra and inter corpus streams on both
   routes, and on both routes seven 64x64 format streams (12-bit, 12-bit
   4:4:4, 4:2:2 at 8, 10 and 12 bit, monochrome, palette in inter frames;
   tests/streams_torch) and inter_grain; the CLI decodes one with
   ``--intraengine`` as a subprocess.
   Config 2 with ``Settings(n_threads=4)`` and the tools path with
   ``Settings(max_frame_delay=3)`` are decoded through the pipelined
   Decoder (entropy || build || pixels || download), with the frame
   delay's pictures in flight, in turns with the serial decode (serial,
   pipelined, pipelined, serial), every pass to the path's md5 and both
   counters moving, then once more staged; the parallel paths run at
   world size 1 on an NCCL mesh: the tile-sharded decode of
   tests/streams_torch/e2e_1080p_sharded.ivf (to the JAX host md5 and
   the Decoder's on the card), the band deblock, CDEF and LR functions
   on config 2's and config 3's first-frame planes (``torch.equal`` with
   the single-device filters) and the dry run's steps
   (parallel/dryrun.run_rank);
3. runs each kernel's wrapper on the card at the shapes config 2 gave
   it, for bit depths 8/10/12, every unit size, put and prep, and at the
   edge shapes (odd widths, one row, one combo, unsorted and duplicate
   combos, int16 wrap, one unit, extreme window origins), and on each
   decode's own largest calls (config 3's at bit depth 10, the tools
   path's, the super-res path's, and the profile paths' at bit depths 12
   and 10, with their largest chroma H-plane calls: 1080x960 at 4:2:2,
   luma-sized at 4:4:4), and requires ``torch.equal`` with the kernel's plain PyTorch
   version; then times the kernel as device time with CUDA events: warm
   (many back-to-back launches queued while the card is busy, over their
   count) and with a cold L2 (a 256 MB write queued before each timed
   launch), beside an empty kernel's launch floor; and the plain version
   as device time (the summed time of the kernels it runs, by
   torch.profiler) and as host wall time per synchronized call. The itx
   kernel (one launch per run of a frame's residual records, over the
   run's work list) is held to ``torch.equal`` with its plain version on
   synthetic work lists that mix every tx size, WHT, dense tails, int16
   and int32 descriptors, pad rows and units cut by the planes' edges, at
   bit depths 8/10/12 in its three modes (clip-add, raw, hres; int32 and
   narrow planes), on one-entry buckets of every tx size, bit depth and
   mode, and on every path's own largest work list of each mode (config
   2, 3 and 4, tools, super-res, engine, the two pipelined paths, the
   tile-sharded decode and the two profile paths) and the tile-sharded
   decode's own one-entry buckets; every path must launch it once a run
   (and never one entry at a time); it is timed on config 2 frame 3's
   clip-add run, on the same buckets as one-entry launches in turns with
   it, and on config 2's largest 32x32 bucket as a one-entry list; config
   2's frame 3 program is replayed with the kernel and with the plain
   version in its place, counting the eager ops of each. The unit MC
   kernels (work-list kernels: one launch a frame's run) are held to
   ``torch.equal`` with their plain versions (ops/mc.mc_units_run,
   mc_scaled_run: mc_unit_batch or mc_scaled_batch with the scatter
   after it, an entry at a time) on 12 mixed synthetic runs
   (tools/mcu_cases; bd 8/10/12, the four (has_h, has_v) cases, put and
   prep, units 2x2 to 128x128, int16 and int32 descriptors, plane and
   arena destinations, OOB16/PAD_OOB pad rows, units cut by the plane's
   edge, scaled steps 512..2048 on a strided reference view), on 685
   one-entry synthetic cases (every Filter2d, duplicate slots, subpel-0
   columns and rows) and on every path's own largest run of each kind
   (the serial and pipelined paths') and the tile-sharded decode's own
   one-entry calls; config 2 frame 3's and the tools path's frame 2
   mcurun and the super-res path's frame 4 mcsrun are timed warm and
   cold against a byte bound (the reference pixels their taps read,
   each once a reference) and against the same entries as one-entry
   launches, with their largest bucket as a one-entry launch; and
   config 2's frame 3 and the super-res path's frame 4 are replayed with
   them and with their plain versions in their place (no plain MC
   function may run in the kernel route), counting eager ops. The
   deblock and CDEF kernels are held to ``torch.equal`` with their plain
   versions (ops/loopfilter.deblock_frame, deblock_plane and _apply_pass,
   ops/cdef.cdef_frame, cdef_filter_plane and cdef_dir) on the synthetic
   cases of tools/filter_cases (random and conflicting edge maps, 16 px
   edges whose taps wrap, bd 8/10/12, luma and chroma of every layout
   and monochrome, odd sizes, frames of several tiles, a band's
   transposed view behind its halo rows, CDEF frames, a 4K CDEF frame
   with every block active, per-block maps with halo rows, direction
   searches) and on every path's own largest call of each wrapper;
   config 2 frame 3's deblock (three planes, one launch) is timed warm
   and cold against a byte and operation bound, beside its plain
   version's device and wall time and beside the same frame as the pass
   kernel's six launches (deblock_plane, torch.equal), and so are config
   4's 4K frame 2's; config 2 frame 3's CDEF (one launch) and the 4K
   CDEF frame the same way; and config 2's frame 3 and config 3's frame 2
   filter programs are replayed with the kernels and with the plain
   versions in their place (no plain deblock or CDEF function may run in
   the kernel route), counting eager ops. The inter tool kernels (the
   warp, the compound joins and the OBMC blend: work-list kernels, one
   launch a warprun, comprun or obmcrun record) are held to
   ``torch.equal`` with their plain versions (ops/mc.warp_run, comp_run,
   obmc_run) on the synthetic cases of tools/tools_cases (bd 8/10/12,
   the three layouts, every join kind, pad slots and rows, edge-cut
   units, phases past the warp table, both OBMC phases; each warp and
   OBMC case as a one-entry list, and a mixed list of each a bit depth;
   each comp case as a mixed list and as a one-entry list of each of its
   records) and on every path's own largest call of each wrapper (the
   tile-sharded decode's comp_run among them); the tools path's frame 1
   calls of each kernel (its warprun, its comprun, its two obmcrun
   records) are timed warm and cold against a byte and operation bound,
   each run also in turns with the same entries as one-entry launches
   (an entry a launch, as the records ran before), beside their plain
   version's device and wall time; and the tools path's frame 1 and the
   super-res path's frame 4
   are replayed with the kernels and with their plain versions in their
   place (no warp8x8_batch, join, obmc_blend_batch, scatter_slot_units
   or per-record plain tool function may run in the kernel route),
   counting eager ops by family;
4. prints the kernel table (ms in the JSON line is the warm time), each
   path's per-frame times, op kinds per frame and stage split, the
   engine path's waves, units and eager ops per wave beside the hybrid
   route's times, the pipelined paths' times between pictures and
   steady fps beside the serial decodes' and their stage split, and
   each parallel step's time (the multi-rank paths run only on the CPU
   under gloo, in the tests: one card takes one NCCL rank);
5. decodes fuzzed copies of four streams (the mutation loop of
   tests/test_error_containment.py) on both routes, on the card and on
   the CPU, and requires equal outcomes (md5, and which temporal units
   raised a contained error), then a clean decode; and prints one JSON
   line of kernel numbers, the card's name and power limit, and as the
   last line the device JSON.

With ``--profile DIR`` it also writes a torch.profiler table of two
steady inter frames to DIR. Any failure raises: the script then exits
non-zero and prints no result. Without a CUDA device it exits non-zero
before doing anything.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
STREAM = os.path.join(HERE, "bench_cache",
                      "e2e_1080p_inter_cdef_727de0883e7e.ivf")
STREAM_MD5 = "383c08fe120aef29ce8709efdab36187"
STREAM3 = os.path.join(HERE, "bench_cache",
                       "e2e_1080p_10bit_grain_lr_6d42abf87190.ivf")
# config 3's md5 with grain and without (Settings.apply_grain), decoded by
# the JAX package's host reference path
CONFIG3_MD5 = {True: "76e6cf803e84aaf3a9089fe53894d4d4",
               False: "6e6909b95f07928266f8c2157ff65a58"}
# config 3 decoded without grain, each picture through the JAX package's
# Decoder.apply_grain (its host reference path)
CONFIG3_APPLY_GRAIN_MD5 = "76e6cf803e84aaf3a9089fe53894d4d4"
# small corpus streams with self-guided and switchable restoration, which
# the config 3 stream (Wiener only) does not carry; md5.txt is grain-free
STREAMS = os.path.join(HERE, "tests", "streams")
LR_STREAMS = ("inter_10bit_lr.ivf", "intra_sb128_lr.ivf")
# the tools path: streams of config 2's parameters with compound, warp,
# OBMC and inter-intra blocks, and a lossless one; md5 and frame count
# from the JAX package's host reference path
TOOLS_DIR = os.path.join(HERE, "tests", "streams_torch")
TOOLS_STREAM = "e2e_1080p_inter_tools.ivf"
SUPERRES_STREAM = "e2e_1080p_superres.ivf"
SHARDED_STREAM = "e2e_1080p_sharded.ivf"
# AV1's Professional profile (12-bit 4:2:2, every inter tool, loop
# restoration, chroma film grain) and High profile (10-bit 4:4:4, every
# inter tool, palette blocks in inter frames) at 1080p
PRO_STREAM = "e2e_1080p_422_12bit.ivf"
HIGH_STREAM = "e2e_1080p_444_10bit.ivf"
# 64x64 streams of 12-bit, 12-bit 4:4:4, 4:2:2 at 8/10/12 bit,
# monochrome and palette in inter frames
FORMAT_STREAMS = ("features0_12bit.ivf", "features1_444_12bit.ivf",
                  "features2_422_8bit.ivf", "features3_422_10bit.ivf",
                  "features4_422_12bit.ivf", "inter16_mono.ivf",
                  "inter39_scc.ivf")
TOOLS_STREAMS = {TOOLS_STREAM: ("8e678ba92fc156763dac7dcfaae2e727", 5),
                 "lossless_128x64.ivf": ("d8bb566f6479722343086a0cb22048e5",
                                         4),
                 SUPERRES_STREAM: ("c365d81ab907f53467bd0ae7762cb0ce", 5),
                 SHARDED_STREAM: ("076650a32371f706c1437177be26aede", 5),
                 PRO_STREAM: ("e4dce1d6efe442cf9b400eccdac09195", 5),
                 HIGH_STREAM: ("9916482c5803fb77ac8fe0f78caa36a6", 5),
                 "features0_12bit.ivf": ("d6856dce530d35f9a63d85bc4481da38",
                                         3),
                 "features1_444_12bit.ivf": (
                     "11ff0933268d4585d2cc30f04064486d", 3),
                 "features2_422_8bit.ivf": (
                     "4bf35ee594fa8ea810836a855fc8d5c7", 3),
                 "features3_422_10bit.ivf": (
                     "3d187e714b09f373abaef9b4185e6d3f", 3),
                 "features4_422_12bit.ivf": (
                     "97ac433eb36e44502493cd98cd04b508", 3),
                 "inter16_mono.ivf": ("4d7a1f4b85605a8c61a33ed7312185f1", 4),
                 "inter39_scc.ivf": ("2e5a1b57ca1005ebc8a7d9cec79c33fb", 4)}
# md5 without film grain of each stream with grain, from the JAX
# package's host reference path; the Professional stream through
# Decoder.apply_grain gives its md5 with grain
NO_GRAIN_MD5 = {PRO_STREAM: "5a0f803eac6e7b2de4adde0f26e376a5"}
# the profile paths: (stream, op kinds each must run)
PROFILE_PATHS = (("pro", PRO_STREAM, ("comp", "warp", "obmc", "lrw",
                                      "lrs")),
                 ("high", HIGH_STREAM, ("comp", "warp", "obmc")))
# corpus stream with film grain, decoded on both routes against md5.txt
# (grain-free) beside FORMAT_STREAMS
GRAIN_CORPUS = ("inter_grain.ivf",)
# the pipelined paths: config 2 and the tools path with these settings
PIPELINED = (("config 2", dict(n_threads=4)),
             ("tools", dict(max_frame_delay=3)))
# corpus stream with super-res frames (tests/streams)
SUPERRES_CORPUS = ("inter_superres.ivf",)
# corpus streams with compound, warp and OBMC blocks (tests/streams)
TOOLS_CORPUS = ("inter_compound_oh.ivf", "inter_warp_obmc.ivf",
                "inter_masked.ivf", "inter_444_masked.ivf",
                "inter_tmvs_skip.ivf")
# config 4: 4K 10-bit, 2x2 tiles, 3 frames
STREAM4 = os.path.join(HERE, "bench_cache",
                       "e2e_4k_10bit_multitile_479aaf4a51e3.ivf")
CONFIG4_MD5 = "c00e0479951b96933a8284c9b4ab0366"
# streams decoded on both routes (hybrid, then the device intra engine)
# against tests/streams/md5.txt
ENGINE_CORPUS = ("intra_420_8bit.ivf", "intra_444_10bit.ivf",
                 "intra_filter_pal.ivf", "intra_sb128_lr.ivf",
                 "inter_basic.ivf", "multitile_2x2.ivf")
# the CLI run on the card (md5.txt's hash of the stream)
CLI_STREAM = ("intra_filter_pal.ivf", "3100692804dd29c7aa78ff45db91aea7")
# the fuzz phase: mutated copies of each stream (the mutation loop of
# tests/test_error_containment.py), each decoded on both routes on the
# card and on the CPU
FUZZ_STREAMS = ("intra_420_8bit.ivf", "inter_basic.ivf",
                "features4_422_12bit.ivf", "inter_444_masked.ivf")
FUZZ_COPIES = 12
FUZZ_SEED = 2026
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SCRATCH_BYTES = 256 << 20    # the cold-L2 write: 5x the H100's 50 MB L2
CYCLES_PER_MS = 2.0e6        # about the H100's clock; sizes busy waits
OPS_FRAME = 3                # the steady config 2 frame whose ops are counted
SR_OPS_FRAME = 4             # the super-res frame (coded 1707 wide) counted
TOOLS_RUN_FRAME = 2          # the tools frame whose unit MC run is timed
TOOLS_OPS_FRAME = 1          # the tools frame whose tool kernels are timed
C3_FILTER_FRAME = 2          # the config 3 frame whose filter ops are counted
C4_FILTER_FRAME = 2          # the config 4 (4K) frame whose filters are timed
# the unit MC kernels' synthetic cases: (uw, uh) of translational units
# (chroma 2-wide and 2-tall, non-square, whole 128x128 blocks) and of
# scaled ones
MCU_UNITS = ((2, 2), (2, 4), (4, 2), (4, 4), (8, 4), (4, 8), (8, 8),
             (16, 4), (8, 32), (32, 32), (64, 16), (128, 128))
MCS_UNITS = ((2, 2), (2, 4), (4, 2), (4, 4), (8, 4), (4, 8), (8, 8),
             (16, 16), (64, 32))
# the kernel libraries that must build with no stack frame and no spill
NO_SPILL = {"itx", "mc_units", "mc_scaled", "deblock", "cdef", "warp",
            "comp", "obmc"}
# the inter tool wrappers (ops/tools_cuda; their plain versions in ops/mc)
# -> their kernel row
TOOLS_FNS = {"warp_run": "warp", "comp_run": "comp", "obmc_run": "obmc"}
# the functions that ran the tools as eager ops before their kernels
# (ops/mc): none may run in the kernel route of a replay
TOOLS_EAGER = ("warp8x8_batch", "obmc_blend_batch", "w_avg_batch",
               "mask_batch", "w_mask_batch", "scatter_slot_units",
               "warp_plane", "warp_slots", "comp_record", "obmc_plane",
               *TOOLS_FNS)
# integer operations a warp unit (120 horizontal and 64 vertical 8-tap
# sums, a multiply and an add a tap), a joined pixel and a blended pixel
WARP_UNIT_OPS = 2 * 8 * (120 + 64)
COMP_PIXEL_OPS = 10
OBMC_PIXEL_OPS = 6
# record kind -> the unit MC wrapper (ops/mcu_cuda) that runs it as a
# one-entry list
MCU_KINDS = {"put": "mc_units_plane", "t": "mc_units_slots",
             "scaled": "mc_scaled_plane", "s": "mc_scaled_slots"}
# run record kind -> the unit MC work-list wrapper (ops/mcu_cuda), its
# plain version (ops/mc) and kernel row
MCU_RUNS = {"mcurun": "mc_units_run", "mcsrun": "mc_scaled_run"}
MCU_ROW = {"mcurun": "mc_units", "mcsrun": "mc_scaled"}
# the mixed synthetic runs of the unit MC kernels (tools/mcu_cases): seeds
# a bit depth
MCU_RUN_SEEDS = 2
# deblock and CDEF wrappers (ops/deblock_cuda, ops/cdef_cuda) -> their
# kernel row; the first two are the ones the frame programs call
FILTER_FNS = {"deblock_frame": "deblock", "cdef_frame": "cdef",
              "deblock_plane": "deblock", "apply_pass": "deblock",
              "cdef_filter_plane": "cdef", "cdef_dir": "cdef"}
# integer operations an edge row of a deblock pass evaluates (the masks
# and candidate sums of csrc/deblock.cu filter_core, luma and chroma, in
# either design: the frame kernel evaluates each active edge row of both
# passes once, from shared memory), a filtered CDEF pixel (twelve
# constrained taps) and a direction search (64 pixels into eight classes,
# then the weighted squares): the operation side of the filter kernels'
# bounds
DBK_EDGE_OPS = {True: 160, False: 60}
HALO_ROWS = 8                # parallel/filter_shard.HALO: a band's halo
CDEF_PIXEL_OPS = 110
CDEF_DIR_OPS = 900
# one-entry launches queued a timing, at most (more fill the launch
# queue, and the host could then not queue ahead of the card)
QUEUE_LAUNCHES = 300


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def build_all():
    """Build the native host library (on import) and the CUDA kernels
    (every source side by side, nvcc with -Xptxas -v, to print registers,
    spills and stack frames). A NO_SPILL library that is up to date is
    checked on the ptxas lines of the build that made it (cuda_build's
    saved log), and rebuilt with -v where that log has none. Fails if a
    kernel of a NO_SPILL library has a stack frame or spills, or if one
    has no ptxas lines to check."""
    t0 = time.perf_counter()
    from dav1d_mirror_tpu_torch.host import native  # builds on import
    t_native = time.perf_counter() - t0
    from dav1d_mirror_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    flags = ["-Xptxas", "-v"]
    logs = cuda_build.build(flags)
    built = sorted(logs)
    saved = sorted(NO_SPILL - set(logs))
    for name in saved:
        path = cuda_build.log_path(name)
        if os.path.exists(path):
            with open(path) as f:
                logs[name] = f.read()
    unchecked = [n for n in sorted(NO_SPILL)
                 if "Compiling entry function" not in logs.get(n, "")]
    if unchecked:
        logs.update(cuda_build.build(flags, force=unchecked))
        built += unchecked
    t_cuda = time.perf_counter() - t0
    print(f"build: cuda kernels {t_cuda:.2f} s (built "
          f"{', '.join(built) or 'none'}; ptxas lines from saved logs: "
          f"{', '.join(n for n in saved if n not in built) or 'none'}), "
          f"native host library {t_native:.2f} s ({native.LIB._name})")
    bad = []
    for name, log in logs.items():
        fn = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name} {fn}: {line.strip()}")
            if name in NO_SPILL and "stack frame" in line:
                nums = [int(w) for w in line.replace(",", " ").split()
                        if w.isdigit()]
                if nums != [0, 0, 0]:
                    bad.append(f"{fn}: {line.strip()}")
    assert not bad, f"stack frame or spills: {bad}"
    missing = [n for n in sorted(NO_SPILL)
               if "Compiling entry function" not in logs.get(n, "")]
    assert not missing, f"no ptxas lines to check for {missing}"


class CallLog:
    """Wraps kernel wrappers (`fns`: (module, name) pairs) while inside
    it, to keep what their calls were given; counts stay the wrappers'
    own. A subclass's seen(name, args, kwargs) places each call: (store,
    key, size, make), store the name of one of its dict attributes. Of
    the calls with one (store, key) the largest by size is kept there, as
    make() gives it; while `keep` is set, every call is also kept in
    `kept` [(name, make())]."""

    def __init__(self, fns):
        self._orig = [(mod, n, getattr(mod, n)) for mod, n in fns]
        self._size = {}
        self.kept = []
        self.keep = False

    def __enter__(self):
        def wrap(name, fn):
            def rec(*a, **k):
                store, key, size, make = self.seen(name, a, k)
                big = size > self._size.get((store, key), -1)
                if big or self.keep:
                    call = make()
                    if big:
                        self._size[(store, key)] = size
                        getattr(self, store)[key] = call
                    if self.keep:
                        self.kept.append((name, call))
                return fn(*a, **k)
            return rec
        for mod, n, fn in self._orig:
            setattr(mod, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for mod, n, fn in self._orig:
            setattr(mod, n, fn)


class ItxLog(CallLog):
    """Keeps, of the itx kernel's wrappers' calls, the largest work list
    of each mode (`runs` {mode: the call's arguments}, largest by work
    items) and the largest one-entry bucket of each (mode, tx size, one
    transform type, dense coefficients) (`itx` {key: the call's
    arguments}), and, where `add_runs` is a list, every clip-add run's
    call. Descriptor buffers, tables, selectors and dense blocks are
    never written after they are made; the planes are, so only their
    shapes and dtypes are kept."""

    def __init__(self):
        from dav1d_mirror_tpu_torch.ops import itx_cuda
        super().__init__([(itx_cuda, "itx_bucket"), (itx_cuda, "itx_run")])
        self.itx = {}
        self.runs = {}
        self.add_runs = None   # a list: keep every clip-add run's call

    def seen(self, name, a, k):
        return (self._bucket if name == "itx_bucket" else self._run)(*a, **k)

    @staticmethod
    def _bucket(mode, vals, pos, sel, tx, bd, plane=None, ys=None, xs=None,
                out_dtype=None):
        return "itx", (mode, tx, not isinstance(sel, tuple), pos is None), \
            vals.shape[0], lambda: dict(
                mode=mode, vals=vals, pos=pos, sel=sel, tx=tx, bd=bd, ys=ys,
                xs=xs, out_dtype=out_dtype, plane=None if plane is None else
                (tuple(plane.shape), plane.dtype))

    def _run(self, mode, tab, work, desc, desc16, bd, planes=(),
             hres_views=(), hres_dtype=None):
        call = dict(
            mode=mode, tab=tab, work=work, desc=desc, desc16=desc16, bd=bd,
            planes=[(tuple(p.shape), p.dtype) for p in planes],
            hres_views=hres_views, hres_dtype=hres_dtype)
        if mode == "add" and self.add_runs is not None:
            self.add_runs.append(call)
        return "runs", mode, work[1], lambda: call


def mcu_unit(kind, dst, rest):
    """(uw, uh) of a unit MC wrapper call: `rest` = its arguments after
    (destination, reference, descriptor rows)."""
    if kind == "t":
        return dst.shape[2], dst.shape[1]
    return (rest[1], rest[2]) if kind == "s" else (rest[2], rest[3])


class McuLog(CallLog):
    """Keeps, of the unit MC kernels' wrappers' calls, the largest work
    list of each run kind by items (`runs` {run kind (MCU_RUNS): its
    call}), the calls of the frame being kept (`kept`, while `keep` is
    set; run_kept gives a run kind's) and the largest one-entry call of
    each record kind (MCU_KINDS) by outputs (`mcu` {kind: its arguments
    and its destination's shape}). Destinations are written, so only
    their shapes and dtypes are kept (and the arena's size); tables and
    descriptor buffers are cloned (a path may reuse its buffers),
    references kept as they are (never written after they are made)."""

    def __init__(self):
        from dav1d_mirror_tpu_torch.ops import mcu_cuda
        self.kind_of = {fn: k for k, fn in (*MCU_KINDS.items(),
                                            *MCU_RUNS.items())}
        super().__init__([(mcu_cuda, fn) for fn in self.kind_of])
        self.mcu = {}
        self.runs = {}

    def seen(self, name, a, k):
        kind = self.kind_of[name]
        if kind in MCU_RUNS:
            tab, work, *rest = a
            *bufs, planes, refs, arena, bd = rest
            return "runs", kind, work[1], lambda: dict(
                tab=tab.clone(), work=work,
                bufs=tuple(b.clone() for b in bufs),
                planes=[(tuple(p.shape), p.dtype) for p in planes],
                refs=list(refs), bd=bd,
                arena_n=0 if arena is None else arena.numel())
        dst, ref, desc, *rest = a
        uw, uh = mcu_unit(kind, dst, rest)
        size = desc.shape[0] * uw * uh
        return "mcu", kind, size, lambda: dict(
            size=size, dst=(tuple(dst.shape), dst.dtype),
            args=(ref,) + tuple(x.clone() if hasattr(x, "clone") else x
                                for x in (desc,) + tuple(rest)))

    def run_kept(self, kind):
        """The last call of run kind `kind` kept while `keep` was set."""
        return [c for n, c in self.kept if n == MCU_RUNS[kind]][-1]


def _clone(v, memo=None):
    """Tensors (also inside tuples, lists and dicts) cloned, strides
    kept; one view given twice is cloned once, so arguments that alias
    (the executor's chroma deblock maps) still do."""
    import torch
    memo = {} if memo is None else memo
    if isinstance(v, torch.Tensor):
        key = (v.device, v.dtype, v.data_ptr(), tuple(v.shape), v.stride())
        if key not in memo:
            memo[key] = v.clone()
        return memo[key]
    if isinstance(v, (tuple, list)):
        return type(v)(_clone(x, memo) for x in v)
    if isinstance(v, dict):
        return {k: _clone(x, memo) for k, x in v.items()}
    return v


def _numel(v):
    return v.numel() if hasattr(v, "numel") else sum(map(_numel, v))


def _first(args, kwargs):
    """A call's first argument, given by position or by name."""
    return args[0] if args else next(iter(kwargs.values()))


def _pass_base(rows, edge_idx, lvl_cur, lvl_prev, e_lut, i_lut, luma,
               bitdepth, base=0):
    return base


class FilterLog(CallLog):
    """Keeps, of the deblock and CDEF kernels' wrappers' (FILTER_FNS)
    calls, the largest of each wrapper by the pixels of its plane or
    planes (`calls` {wrapper: (args, kwargs)}; apply_pass's of each base,
    as "apply_pass base N") and every call while `keep` is set (`kept`:
    [(wrapper, (args, kwargs))]). Arguments are cloned (apply_pass writes
    its rows, and a path may reuse its buffers)."""

    def __init__(self):
        from dav1d_mirror_tpu_torch.ops import cdef_cuda, deblock_cuda
        super().__init__([(deblock_cuda if row == "deblock" else cdef_cuda,
                           n) for n, row in FILTER_FNS.items()])
        self.calls = {}

    def seen(self, name, a, k):
        key = name if name != "apply_pass" else \
            f"{name} base {_pass_base(*a, **k)}"
        return "calls", key, _numel(_first(a, k)), \
            lambda: _clone((a, k))


class ToolsLog(CallLog):
    """Keeps, of the inter tool kernels' wrappers' (TOOLS_FNS) calls, the
    largest of each wrapper by its outputs (`calls` {wrapper: (args,
    kwargs)}) and every call while `keep` is set (`kept`: [(wrapper,
    (args, kwargs))]; a run by its units or pixels). Arguments are
    cloned (the wrappers write their destinations in place, and obmc_run
    reads the planes it writes), but for the warp's reference stacks,
    which are never written after they are made."""

    def __init__(self):
        from dav1d_mirror_tpu_torch.ops import tools_cuda
        super().__init__([(tools_cuda, n) for n in TOOLS_FNS])
        self.calls = {}

    def seen(self, name, a, k):
        if name == "warp_run":
            return "calls", name, a[1][1], lambda: (
                _clone(a[:5]) + (a[5],) + _clone(a[6:]), _clone(k))
        return "calls", name, a[1][-1], lambda: _clone((a, k))


class ShapeLog:
    """Wraps the kernel wrappers during the decode to record the
    shapes the main path gives them (counts stay the wrappers' own; for
    the itx kernel, ItxLog's largest buckets, as `itx`; for the unit MC
    kernels McuLog's largest run of each kind, as `mcu_runs`, and
    largest one-entry call of each record kind, as `mcu`), the program
    executor to tally the op kinds of each frame (and the "t" and "s"
    sub-ops of comp and obmc ops, as "comp t", "comp s", ...) and its
    slot arena's bytes, and the decoder's frame execution to count the
    inter-intra blocks (dd == 2: device put, host blend) it finished and
    to record each frame's coded and output widths; the deblock and CDEF
    wrappers' largest calls (FilterLog's, as `filters`). With
    keep_frame = i, it keeps frame i's program (the execute_program
    arguments) as `kept_program` and its unit MC runs' calls (a run
    kind's by `mcu_kept(kind)`); with keep_filter_frame = i, frame i's
    filter program (tools/filter_ops.is_filter_program) as
    `kept_filter` and its deblock and CDEF calls as `filter_kept`; the
    inter tool wrappers' largest calls (ToolsLog's, as `tools`), and with
    keep_ops_frame = i, frame i's program with comp records as
    `kept_ops_program` and its tool kernel calls as `tools_kept`."""

    def __init__(self, mc_cuda, frame_exec, api, intra=None):
        self._itx_log = ItxLog()
        self.itx = self._itx_log.itx
        self.runs = self._itx_log.runs
        # every clip-add run's call (config 2: its largest 32x32 bucket)
        self._itx_log.add_runs = self.add_runs = []
        # itx launches the programs' work lists call for: one a run with
        # work items
        self.itx_expected = 0
        self.keep_frame = None
        self.kept_program = None
        self.keep_filter_frame = None
        self.kept_filter = None
        self._filter_log = FilterLog()
        self.filters = self._filter_log.calls
        self.filter_kept = self._filter_log.kept
        self.keep_ops_frame = None
        self.kept_ops_program = None
        self._tools_log = ToolsLog()
        self.tools = self._tools_log.calls
        self.tools_kept = self._tools_log.kept
        self.mc_cuda = mc_cuda
        self.frame_exec = frame_exec
        self.api = api
        self.intra = intra
        self.routes = []     # per frame: "intra", "mixed" or "hybrid"
        self.full_device = []  # per frame: no host pass 2
        self.scans = []      # per frame: [(waves, units, filter cells)]
        self.scan_ops = []   # per frame: eager ops of its scans (counted)
        self.count_ops = None  # an op-counting dispatch mode class
        self.hplanes = []   # (R, H, W, C, bd)
        self.vpass = []     # (B, uw, uh, C, H, w_mid, bd)
        self.vpass_args = {}  # (uw, uh) -> (args, bd) of its largest put
        self.hplanes_args = None  # (refs, combos, bd) of the largest call
        self.hplanes_chroma_args = None  # the same of a chroma plane
        self._hpx_planes = []  # planes of the frame program's hpx ops
        self.frame_ops = []  # per frame: {op kind: count}
        # record kind (MCU_KINDS) -> the largest call (McuLog)
        self._mcu_log = McuLog()
        self.mcu = self._mcu_log.mcu
        self.mcu_runs = self._mcu_log.runs
        self.mcu_kept = self._mcu_log.run_kept
        self.arena = []      # per frame: slot arena bytes
        self.ii_blocks = 0   # inter-intra blocks of the decode
        self.widths = []     # per frame: (coded width, output width)
        self._orig = (mc_cuda.mc_hplanes, mc_cuda.mc_unit_batch_hv,
                      frame_exec.execute_program, api.execute_frame_program,
                      api.run_intra_frame,
                      intra.intra_scan if intra else None)

    def on_frame(self, i):
        self.frame_ops.append({})
        self.arena.append(0)
        self.scans.append([])
        self.scan_ops.append(0)

    def __enter__(self):
        from dav1d_mirror_tpu_torch.tools.filter_ops import \
            is_filter_program
        hp, vp, ex, ef, ri, scan = self._orig

        def rec_ex(sig, *args):
            ops = self.frame_ops[-1]
            keep = len(self.frame_ops) - 1 == self.keep_frame and \
                self.kept_program is None and any(
                    rec[0] in MCU_RUNS for rec in sig[0])
            if keep:
                self.kept_program = (sig,) + args
            keep_f = (self.kept_filter is None and
                      len(self.frame_ops) - 1 == self.keep_filter_frame and
                      is_filter_program(sig))
            if keep_f:
                self.kept_filter = (sig,) + args
            keep_o = (self.kept_ops_program is None and
                      len(self.frame_ops) - 1 == self.keep_ops_frame and
                      any(rec[0] == "comp" for rec in sig[0]))
            if keep_o:
                self.kept_ops_program = (sig,) + args
            # the program's hpx ops call mc_hplanes in this order
            self._hpx_planes = [rec[1] for rec in sig[0] if rec[0] == "hpx"]
            for rec in sig[0]:
                ops[rec[0]] = ops.get(rec[0], 0) + 1
                if rec[0] == "itxrun":
                    assert rec[3][0] > 0, "an itxrun without entries"
                    self.itx_expected += rec[3][1] > 0
                if rec[0] == "comp":     # the two sides' sub-ops
                    subs = rec[5][0] + rec[5][1]
                elif rec[0] == "obmc":
                    subs = rec[7]
                else:
                    subs = ()
                for sub in subs:
                    if sub[0] in "tsw":
                        k = f"{rec[0]} {sub[0]}"
                        ops[k] = ops.get(k, 0) + 1
                if rec[0] == "mcarena":
                    self.arena[-1] += 4 * rec[1]
            self._mcu_log.keep = keep
            self._filter_log.keep = keep_f
            self._tools_log.keep = keep_o
            try:
                return ex(sig, *args)
            finally:
                self._mcu_log.keep = False
                self._filter_log.keep = False
                self._tools_log.keep = False

        def rec_ef(built, seq, fhdr, *args):
            self.widths.append(tuple(fhdr.width))
            self.ii_blocks += sum(int((dd == 2).sum())
                                  for dd in built.dd_per)
            self.routes.append("mixed" if built.intra_engine else "hybrid")
            self.full_device.append(bool(built.full_device))
            return ef(built, seq, fhdr, *args)

        def rec_ri(prog, bufs, device):
            self.widths.append(tuple(bufs.fhdr.width))
            self.routes.append("intra")
            self.full_device.append(True)
            return ri(prog, bufs, device)

        def rec_scan(planes, res, mrows, moffs, frows, foffs, *args):
            self.scans[-1].append((len(moffs) - 1, int(mrows.shape[0]),
                                   int(frows.shape[0])))
            if self.count_ops is None:
                return scan(planes, res, mrows, moffs, frows, foffs, *args)
            counter = self.count_ops()
            with counter:
                out = scan(planes, res, mrows, moffs, frows, foffs, *args)
            self.scan_ops[-1] += counter.n
            return out

        def rec_hp(ref_stack, combos, bd):
            self.hplanes.append(tuple(ref_stack.shape) +
                                (combos.shape[0], bd))
            size = lambda r, c, *_: (r.shape[1] * r.shape[2], c.shape[0])
            kept = self.hplanes_args
            if kept is None or size(ref_stack, combos) > size(*kept):
                # the reference stack is never written after it is made
                self.hplanes_args = (ref_stack, combos.clone(), bd)
            plane = self._hpx_planes.pop(0) if self._hpx_planes else 0
            kept = self.hplanes_chroma_args
            if plane and (kept is None or
                          size(ref_stack, combos) > size(*kept)):
                self.hplanes_chroma_args = (ref_stack, combos.clone(), bd)
            return hp(ref_stack, combos, bd)

        def rec_vp(args, uw, uh, bd, prep):
            B = args[1].shape[0]
            self.vpass.append((B, uw, uh) + tuple(args[0].shape) + (bd,))
            kept = self.vpass_args.get((uw, uh))
            if not prep and (kept is None or B > kept[0][1].shape[0]):
                # the H-plane stack is never written after it is made
                self.vpass_args[(uw, uh)] = ((args[0], *(
                    c.clone() for c in args[1:])), bd)
            return vp(args, uw, uh, bd, prep)

        self.mc_cuda.mc_hplanes = rec_hp
        self.mc_cuda.mc_unit_batch_hv = rec_vp
        self._mcu_log.__enter__()
        self._itx_log.__enter__()
        self._filter_log.__enter__()
        self._tools_log.__enter__()
        self.frame_exec.execute_program = rec_ex
        self.api.execute_frame_program = rec_ef
        self.api.run_intra_frame = rec_ri
        if self.intra is not None:
            self.intra.intra_scan = rec_scan
        return self

    def __exit__(self, *exc):
        (self.mc_cuda.mc_hplanes, self.mc_cuda.mc_unit_batch_hv,
         self.frame_exec.execute_program,
         self.api.execute_frame_program, self.api.run_intra_frame,
         scan) = self._orig
        if self.intra is not None:
            self.intra.intra_scan = scan
        self._mcu_log.__exit__(*exc)
        self._itx_log.__exit__(*exc)
        self._filter_log.__exit__(*exc)
        self._tools_log.__exit__(*exc)


def op_counter(torch):
    """A dispatch mode that counts the aten ops issued inside it: every
    eager op the host dispatches, views included."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCount(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))
    return OpCount


def check_engine_routes(shapes, name):
    """On a decode with the intra engine on: a frame on the engine's own
    route ("intra") or in an inter frame's program ("mixed") ran one
    intrascan and no host pass 2; a "hybrid" frame ran none. Returns
    {route: frames}."""
    for i, (route, full, ops) in enumerate(zip(
            shapes.routes, shapes.full_device, shapes.frame_ops)):
        if route == "hybrid":
            assert "intrascan" not in ops, (name, i, ops)
        else:
            assert ops.get("intrascan") == 1 and full, (name, i, route, ops)
    return {r: shapes.routes.count(r) for r in ("intra", "mixed", "hybrid")}


def mutate(np, units, rng):
    """One fuzzed copy of a stream's temporal units: per OBU, with
    probability 1/2, a truncation or a bit flip (the mutation loop of
    tests/test_error_containment.py)."""
    out = []
    for obus in units:
        mut = []
        for o in obus:
            o = bytearray(o)
            if len(o) and rng.random() < 0.5:
                if rng.random() < 0.5 and len(o) > 2:
                    o = o[:rng.integers(1, len(o))]   # truncate
                else:
                    o[rng.integers(0, len(o))] ^= \
                        1 << rng.integers(0, 8)       # bit flip
            mut.append(bytes(o))
        out.append(mut)
    return out


def fuzz_outcome(api, MD5Muxer, units, device, engine):
    """Decode fuzzed units: (per temporal unit "E" for a contained error or
    the pictures it gave, md5 of every picture, pictures)."""
    dec = api.Decoder(api.Settings(device=device, logger=None,
                                   apply_grain=False, intra_engine=engine))
    mux = MD5Muxer()
    per_tu = []
    for obus in units:
        try:
            dec.send_obus(obus)
            err = False
        except api.DecodeError:
            err = True
        n = 0
        while (pic := dec.get_picture()) is not None:
            mux.write(pic)
            n += 1
        per_tu.append("E" if err else n)
    return tuple(per_tu), mux.digest(), mux.n


def fuzz_phase(api, MD5Muxer, torch, np, open_demuxer):
    """Every fuzzed copy, on both routes: the outcome on the card equals
    the outcome on the CPU. Returns (copies, decodes, copies with an
    error, seconds)."""
    t0 = time.perf_counter()
    n_copies = n_dec = n_err = 0
    for si, name in enumerate(FUZZ_STREAMS):
        where = TOOLS_DIR if name in TOOLS_STREAMS else STREAMS
        with open(os.path.join(where, name), "rb") as f:
            units = list(open_demuxer(f.read())[1])
        rng = np.random.default_rng(FUZZ_SEED + si)
        for trial in range(FUZZ_COPIES):
            copy = mutate(np, units, rng)
            n_copies += 1
            erred = False
            for engine in (False, True):
                got = fuzz_outcome(api, MD5Muxer, copy, "cuda", engine)
                torch.cuda.synchronize()
                want = fuzz_outcome(api, MD5Muxer, copy, "cpu", engine)
                n_dec += 2
                assert got == want, (
                    f"fuzz {name} copy {trial} engine {engine}: card "
                    f"{got} != CPU {want}")
                erred |= "E" in got[0]
            n_err += erred
    return n_copies, n_dec, n_err, time.perf_counter() - t0


def decode(api, MD5Muxer, frames, torch, on_frame=None, **settings):
    dec = api.Decoder(api.Settings(device="cuda", **settings))
    mux = MD5Muxer()
    times = []
    for i, fr in enumerate(frames):
        if on_frame is not None:
            on_frame(i)
        t0 = time.perf_counter()
        dec.send_data(fr.data)
        while (pic := dec.get_picture()) is not None:
            mux.write(pic)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return mux.digest(), mux.n, times


def decode_pipelined(api, MD5Muxer, frames, torch, **settings):
    """Decode taking a picture only once get_frame_delay(settings) frames
    are pending (dav1d's frame delay; 1 = right after its frame): a
    caller that waits for each picture right after sending its frame
    leaves the pipeline nothing to overlap. Returns (md5, pictures, the
    seconds between successive pictures, the first from the start)."""
    s = api.Settings(device="cuda", **settings)
    delay = api.get_frame_delay(s)
    dec = api.Decoder(s)
    mux = MD5Muxer()
    stamps = [time.perf_counter()]

    def take():
        pic = dec.get_picture()
        if pic is None:
            return False
        mux.write(pic)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return True

    try:
        for sent, fr in enumerate(frames, 1):
            dec.send_data(fr.data)
            while sent - (len(stamps) - 1) >= delay and take():
                pass
        dec.drain()
        while take():
            pass
    finally:
        dec.close()
    return mux.digest(), mux.n, [b - a for a, b in zip(stamps, stamps[1:])]


def pipelined_phase(api, MD5Muxer, torch, stages, counted, paths):
    """Each path of PIPELINED, decoded in turns serial, pipelined,
    pipelined, serial (both through decode_pipelined, the serial one with
    a frame delay of 1), every pass to the path's md5, both kernel
    counters moving in the first pipelined pass; then pipelined once
    more, staged, under ItxLog, McuLog, FilterLog and ToolsLog. paths:
    {name: (frames, md5)}. Returns ({name: launches}, {name: ItxLog},
    {name: McuLog}, {name: FilterLog}, {name: ToolsLog})."""
    out, logs, mcu_logs, filter_logs, tools_logs = {}, {}, {}, {}, {}
    for name, settings in PIPELINED:
        frames, md5 = paths[name]
        runs = []
        for piped in (False, True, True, False):
            kw = settings if piped else {}
            (d, n, times), launches = counted(lambda: decode_pipelined(
                api, MD5Muxer, frames, torch, **kw))
            assert (d, n) == (md5, len(frames)), (name, kw, d, n)
            runs.append((piped, times, launches))
        launches = runs[1][2]
        moved(launches, name)
        with ItxLog() as logs[name], McuLog() as mcu_logs[name], \
                FilterLog() as filter_logs[name], \
                ToolsLog() as tools_logs[name]:
            (ds, _, times_s), split = staged(
                stages, lambda: decode_pipelined(api, MD5Muxer, frames,
                                                 torch, **settings))
        assert ds == md5, (name, "staged", ds)
        print(f"pipelined {name} ({settings}): md5 {md5} in every pass, "
              f"{len(frames)} frames, launches {launches}")
        for piped, times, _ in runs:
            steady = times[2:]
            print(f"pipelined {name} {'pipelined' if piped else 'serial'} "
                  f"pass: ms between pictures " +
                  ", ".join(f"{t * 1e3:.1f}" for t in times) +
                  f"; steady fps over frames 2-{len(times) - 1} "
                  f"{len(steady) / sum(steady):.3f}; whole stream "
                  f"{sum(times):.2f} s")
        print(f"pipelined {name} stage split (staged pass, "
              f"{sum(times_s) * 1e3:.1f} ms wall; stages overlap, device, "
              f"host-pass2 and filters run on the pixel worker): " +
              ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in
                        sorted(split.items(), key=lambda kv: -kv[1])))
        out[name] = launches
    return out, logs, mcu_logs, filter_logs, tools_logs


def profile_phase(api, MD5Muxer, torch, stages, counted, mc_cuda,
                  frame_exec, parse_ivf, key, name, kinds):
    """One profile path (PROFILE_PATHS): a counted decode under ShapeLog
    to the stream's md5 with both counters moving and every op kind of
    `kinds` run, a second decode to the same md5 (CUDA applies duplicate
    scatter indices in any order), a staged pass; a stream with grain
    also decodes without it and, without it, through
    Decoder.apply_grain, each to its own md5. Returns the path's
    report."""
    with open(os.path.join(TOOLS_DIR, name), "rb") as f:
        _, _, _, frames = parse_ivf(f.read())
    md5, n_frames = TOOLS_STREAMS[name]
    with ShapeLog(mc_cuda, frame_exec, api) as shapes:
        (d, n, times), launches = counted(lambda: decode(
            api, MD5Muxer, frames, torch, shapes.on_frame))
    assert n == len(frames) == n_frames, (key, n, len(frames))
    assert d == md5, f"{key} md5 {d} != {md5}"
    moved(launches, key)
    one_launch_per_run(shapes, launches, key)
    filter_launches(shapes, launches, key)
    tools_launches(shapes, launches, key)
    ran = {k for ops in shapes.frame_ops for k in ops}
    assert set(kinds) <= ran, (key, sorted(ran))
    assert shapes.ii_blocks > 0, f"{key} ran no inter-intra block"
    d2, _, _ = decode(api, MD5Muxer, frames, torch)
    assert d2 == md5, f"{key} md5 {d2} (second pass)"
    (d_st, _, times_st), split = staged(
        stages, lambda: decode(api, MD5Muxer, frames, torch))
    assert d_st == md5, f"{key} md5 {d_st} (staged pass)"
    digests = {"expected": md5, "got": d, "second": d2, "staged": d_st}
    if name in NO_GRAIN_MD5:
        assert split.get("grain", 0) > 0, (key, split)
        # one decode without grain: each picture hashed as it is, and
        # through Decoder.apply_grain (which returns a new picture)
        dec = api.Decoder(api.Settings(device="cuda", apply_grain=False))
        plain, grained = MD5Muxer(), MD5Muxer()
        for fr in frames:
            dec.send_data(fr.data)
            while (pic := dec.get_picture()) is not None:
                plain.write(pic)
                grained.write(dec.apply_grain(pic))
        torch.cuda.synchronize()
        assert (plain.digest(), plain.n) == (NO_GRAIN_MD5[name], n_frames), \
            f"{key} md5 without grain {plain.digest()}"
        assert (grained.digest(), grained.n) == (md5, n_frames), (
            f"{key} through Decoder.apply_grain: md5 {grained.digest()}")
        digests.update({"no grain": plain.digest(),
                        "apply_grain": grained.digest()})
    return dict(frames=frames, times=times, shapes=shapes,
                launches=launches, digests=digests, split=split,
                staged_s=sum(times_st))


def formats_phase(api, MD5Muxer, torch, mc_cuda, frame_exec, intra,
                  parse_ivf, corpus_md5):
    """The small format streams and GRAIN_CORPUS on both routes (hybrid,
    then the device intra engine), each to its recorded md5."""
    for name in FORMAT_STREAMS + GRAIN_CORPUS:
        corpus = name in GRAIN_CORPUS
        with open(os.path.join(STREAMS if corpus else TOOLS_DIR, name),
                  "rb") as f:
            _, _, _, fr = parse_ivf(f.read())
        want = corpus_md5[name] if corpus else TOOLS_STREAMS[name][0]
        for engine in (False, True):
            # no format stream has grain; md5.txt is grain-free
            with ShapeLog(mc_cuda, frame_exec, api, intra) as c_shapes:
                d, n, _ = decode(api, MD5Muxer, fr, torch,
                                 c_shapes.on_frame, apply_grain=False,
                                 intra_engine=engine)
            assert d == want, f"{name} engine {engine}: md5 {d} != {want}"
            rts = check_engine_routes(c_shapes, name)
            if engine:
                assert c_shapes.routes[0] == "intra", c_shapes.routes
            else:
                assert rts["hybrid"] == n, rts
            print(f"{name}: md5 {d} as recorded on the "
                  f"{'engine' if engine else 'hybrid'} route, {n} frames, "
                  f"routes {rts}, H-plane calls {len(c_shapes.hplanes)}, "
                  f"V-pass calls {len(c_shapes.vpass)}")


def parallel_phase(torch):
    """The parallel paths at world size 1 on the card (NCCL): the sharded
    stream decode of SHARDED_STREAM against its JAX host md5 and the
    port's Decoder on the card, the band functions on config 2's and
    config 3's first-frame planes and parameters against the
    single-device filters, and the dry run's steps at its shapes (its
    itx buckets under ItxLog, its unit MC calls under McuLog, its band
    deblock and CDEF calls under FilterLog, its comp runs under
    ToolsLog). Returns (steps, frame checks, ItxLog, McuLog, FilterLog,
    ToolsLog)."""
    from dav1d_mirror_tpu_torch.ops import (cdef_cuda, deblock_cuda,
                                            itx_cuda, mcu_cuda, tools_cuda)
    from dav1d_mirror_tpu_torch.parallel import dryrun
    from dav1d_mirror_tpu_torch.parallel.mesh import close_mesh, init_mesh
    with open(os.path.join(TOOLS_DIR, SHARDED_STREAM), "rb") as f:
        sharded = f.read()
    t0 = time.perf_counter()
    mesh = init_mesh(1, 0, f"tcp://127.0.0.1:{dryrun.free_port()}", "cuda")
    print(f"parallel: NCCL mesh of world size 1 formed in "
          f"{time.perf_counter() - t0:.2f} s")
    # the itx, unit MC, deblock, CDEF and comp kernels' launches in the
    # tile-sharded decode
    sharded_itx, sharded_units, sharded_filters = [], [], []
    sharded_comp = []
    real_decode = dryrun.sharded_stream_decode

    def counted_decode(*args):
        n0, u0 = itx_cuda.ITX_LAUNCHES, mcu_cuda.UNITS_LAUNCHES
        d0, c0 = deblock_cuda.DEBLOCK_LAUNCHES, cdef_cuda.CDEF_LAUNCHES
        j0 = tools_cuda.COMP_LAUNCHES
        try:
            return real_decode(*args)
        finally:
            sharded_itx.append(itx_cuda.ITX_LAUNCHES - n0)
            sharded_units.append(mcu_cuda.UNITS_LAUNCHES - u0)
            sharded_filters.append((deblock_cuda.DEBLOCK_LAUNCHES - d0,
                                    cdef_cuda.CDEF_LAUNCHES - c0))
            sharded_comp.append(tools_cuda.COMP_LAUNCHES - j0)
    dryrun.sharded_stream_decode = counted_decode
    try:
        with ItxLog() as itx_log, McuLog() as mcu_log, \
                FilterLog() as filter_log, ToolsLog() as tools_log:
            steps = dryrun.run_rank(mesh, 1, sharded)
        frame_checks = {}
        for cfg, path in (("config 2", STREAM), ("config 3", STREAM3)):
            with open(path, "rb") as f:
                ff = dryrun.first_frame(f.read(), "cuda")
            for k, v in dryrun.filter_checks(mesh, *ff).items():
                frame_checks[f"{cfg} {k}"] = v
    finally:
        dryrun.sharded_stream_decode = real_decode
        close_mesh()
    assert sharded_itx and sharded_itx[0] > 0, sharded_itx
    assert sharded_units and sharded_units[0] > 0, sharded_units
    # the stream deblocks and runs CDEF in every frame, and codes
    # compound blocks (average and distance weights)
    assert sharded_filters and min(sharded_filters[0]) > 0, sharded_filters
    assert sharded_comp and sharded_comp[0] > 0, sharded_comp
    assert set(tools_log.calls) == {"comp_run"}, sorted(tools_log.calls)
    st = steps["sharded_stream_decode"]
    want = TOOLS_STREAMS[SHARDED_STREAM]
    assert (st["md5"], st["frames"]) == want, (st, want)
    bad = [k for k, v in list(steps.items()) + list(frame_checks.items())
           if not v["equal"]]
    assert not bad, f"parallel checks unequal: {bad}"
    kinds = {k.split()[2] for k in frame_checks}
    assert kinds == {"band_deblock_plane", "band_cdef_plane",
                     "shard_lr_batch"}, kinds
    print(f"parallel: {SHARDED_STREAM} decoded tile-sharded, md5 "
          f"{st['md5']} as the JAX host reference and the port's Decoder "
          f"on the card ({st['decoder_md5']}), {st['frames']} frames, "
          f"{st['ms']:.1f} ms tile-sharded against {st['decoder_ms']:.1f} "
          f"ms through the Decoder; {sharded_itx[0]} itx, "
          f"{sharded_units[0]} mc_units, {sharded_filters[0][0]} deblock, "
          f"{sharded_filters[0][1]} CDEF and {sharded_comp[0]} comp "
          f"launches in the tile-sharded decode")
    for k, v in steps.items():
        print(f"parallel step {k}: equal, {v['ms']:.2f} ms")
    for k, v in frame_checks.items():
        print(f"parallel {k} at {v['shape']}: torch.equal with the "
              f"single-device op; band {v['ms']:.2f} ms, single-device "
              f"{v['plain_ms']:.2f} ms")
    print("parallel: the multi-rank paths (2 and 4 ranks) ran only on the "
          "CPU under gloo (tests/test_torch_parallel.py): NCCL puts no two "
          "ranks on one GPU, and this machine has one card")
    assert any(dense for (_, _, _, dense) in itx_log.itx), \
        "the tile-sharded decode ran no dense itx bucket"
    assert "put" in mcu_log.mcu, \
        f"the tile-sharded decode's unit MC calls: {sorted(mcu_log.mcu)}"
    assert {"apply_pass base 0", f"apply_pass base {HALO_ROWS}",
            "cdef_filter_plane", "cdef_dir"} <= set(filter_log.calls), \
        sorted(filter_log.calls)
    return steps, frame_checks, itx_log, mcu_log, filter_log, tools_log


def _event(torch):
    return torch.cuda.Event(enable_timing=True)


def _queue_ahead(torch, enqueue, busy_ms=2.0):
    """Run enqueue() while the card is kept busy (torch.cuda._sleep), so
    that the host has queued all of its work before the card reaches
    it and the events it records bracket device work only. enqueue
    returns its events, the first recorded first. Doubles the busy time
    until the host finished queueing before the card reached the first
    event."""
    for _ in range(10):
        start = _event(torch)
        start.record()
        torch.cuda._sleep(int(busy_ms * CYCLES_PER_MS))
        t0 = time.perf_counter()
        events = enqueue()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if start.elapsed_time(events[0]) > host_ms:
            return events
        busy_ms *= 2
    raise RuntimeError("the host could not queue ahead of the card")


def time_warm(torch, fn, n):
    """Device ms per launch: n back-to-back launches of fn between one
    pair of CUDA events, the elapsed time over n."""
    fn()
    torch.cuda.synchronize()

    def enqueue():
        a, b = _event(torch), _event(torch)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        return a, b
    a, b = _queue_ahead(torch, enqueue)
    return a.elapsed_time(b) / n


def time_cold(torch, fn, scratch, n):
    """Median device ms of n launches of fn with a cold L2: before each
    timed launch a write of `scratch` (several times the 50 MB L2) is
    queued outside its pair of events."""
    fn()
    torch.cuda.synchronize()

    def enqueue():
        events = []
        for i in range(n):
            scratch.fill_(i & 127)
            a, b = _event(torch), _event(torch)
            a.record()
            fn()
            b.record()
            events += [a, b]
        return events
    ev = _queue_ahead(torch, enqueue)
    return statistics.median(ev[2 * i].elapsed_time(ev[2 * i + 1])
                             for i in range(n))


def bound(n_bytes, n_ops):
    """(least ms, what bounds it) at the H100's published rates."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / CUDA_CORE_OPS_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def _hp_combos(rng, np, n_ref, c, sort):
    combos = np.stack([rng.integers(0, n_ref, c), rng.integers(0, 6, c),
                       rng.integers(1, 16, c)], 1).astype(np.int32)
    if sort:   # the planner's order (np.unique rows: by reference first)
        combos = combos[np.lexsort(combos.T[::-1])]
    return combos


def hplanes_edge_cases(rng, np):
    """(label, refs, combos, bd) of the shapes that the vector stores,
    peeled heads, row bands and combo runs can get wrong."""
    cases = []

    def add(label, r, h, w, c, bd, hi=None, combos=None):
        refs = rng.integers(0, hi or 1 << bd, (r, h, w), dtype=np.int32)
        if combos is None:
            combos = _hp_combos(rng, np, r, c, False)
        cases.append((label, refs, combos, bd))
    add("odd W=37, H=13", 3, 13, 37, 10, 8)
    add("odd W=961, H=9", 2, 9, 961, 7, 10)
    add("H=1", 2, 1, 64, 8, 8)
    add("C=1", 2, 20, 48, 1, 12)
    add("C=7", 2, 17, 1920, 7, 8)
    alt = _hp_combos(rng, np, 3, 12, False)
    alt[:, 0] = np.arange(12) % 2 * 2
    add("alternating refs", 3, 11, 70, 12, 8, combos=alt)
    dup = _hp_combos(rng, np, 2, 12, True)
    dup[6:] = dup[:6]
    add("duplicate combos", 2, 10, 33, 12, 10, combos=dup)
    # reference values up to 2^15, beyond 12-bit pixels (whose mid values
    # peak at 23546), so the int16 store wraps
    add("bd12 int16 wrap", 2, 12, 45, 9, 12, hi=1 << 15)
    return cases


def vpass_edge_cases(rng, np, torch, dev):
    """(label, args, uw, uh, bd) over every unit size in {2,4,8}^2, bd
    8/10/12: B = 1 and B = 131 (no multiple of any units-per-block
    count), ox at -15 and W-1, oy far above and below the plane, on an
    odd-width plane (rows start at odd elements too) that starts 0, 1
    or 3 elements into an 8-byte word (bd 8, 10, 12)."""
    Cs, Hs, Wd = 3, 20, 37
    w_mid = Wd + 22
    cases = []
    for uw in (2, 4, 8):
        for uh in (2, 4, 8):
            for bd in (8, 10, 12):
                skew = {8: 0, 10: 1, 12: 3}[bd]
                flat = torch.from_numpy(rng.integers(
                    -(1 << 15), 1 << 15, Cs * Hs * w_mid + skew,
                    dtype=np.int16)).to(dev)
                hstack = flat[skew:].view(Cs, Hs, w_mid)
                for B in (1, 131):
                    k = np.arange(B)
                    ox = np.where(k % 3 == 0, -15, np.where(
                        k % 3 == 1, Wd - 1, rng.integers(-15, Wd, B)))
                    oy = np.where(k % 4 == 0, -1000, np.where(
                        k % 4 == 1, Hs + 1000, rng.integers(-8, Hs, B)))
                    cols = [rng.integers(0, Cs, B), oy, ox,
                            rng.integers(1, 16, B), rng.integers(0, 3, B)]
                    cols = [torch.from_numpy(c.astype(np.int32)).to(dev)
                            for c in cols]
                    cases.append((f"{uw}x{uh} bd{bd} B={B}",
                                  (hstack, *cols), uw, uh, bd))
    return cases


def kernel_phase(torch, np, mc, mc_cuda, shapes):
    """Each kernel against its plain version on the card (torch.equal):
    at the decode's shapes for bd 8/10/12 (and, for the V-pass, every
    unit size of the decode, put and prep), and at the edge shapes.
    Times each kernel warm and with a cold L2, and the empty-launch
    floor. Returns the per-kernel rows of the JSON line."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    scratch = torch.empty(SCRATCH_BYTES, dtype=torch.uint8, device=dev)
    floor_ms = time_warm(torch, mc_cuda.empty_launch, 200)
    print(f"  empty launch (floor): {floor_ms:.5f} ms warm")
    rows = []

    # ---- H-plane kernel ----
    def check_hp(refs, combos_t, bd, label):
        got = mc_cuda.mc_hplanes(refs, combos_t, bd)
        want = mc.mc_hplanes(refs, combos_t, bd)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want), \
            f"mc_hplanes differs from its plain version: {label}"
        return int((got.to(torch.int32) - want.to(torch.int32)).abs().max())

    # the decode's largest luma call, and each plane size it used
    R, H, W, C, _ = max(shapes.hplanes, key=lambda s: (s[1] * s[2], s[3]))
    decode_cases = []
    for bd in (8, 10, 12):
        refs = torch.from_numpy(rng.integers(
            0, 1 << bd, (R, H, W), dtype=np.int32)).to(dev)
        n_ref = max(1, min(R, 2))   # combos over a couple of references
        decode_cases.append((f"bd{bd} C={C} {R}x{H}x{W}", refs,
                             _hp_combos(rng, np, n_ref, C, False), bd))
    for r_, h_, w_, c_ in sorted({s[:4] for s in shapes.hplanes}):
        if (h_, w_) != (H, W):
            refs = torch.from_numpy(rng.integers(
                0, 256, (r_, h_, w_), dtype=np.int32)).to(dev)
            decode_cases.append((f"bd8 C={c_} {r_}x{h_}x{w_}", refs,
                                 _hp_combos(rng, np, min(r_, 2), c_, True),
                                 8))
    # the timed case: combos sorted by reference, as the planner gives them
    t_refs = decode_cases[0][1]
    t_combos = _hp_combos(rng, np, max(1, min(R, 2)), C, True)
    t_combos_d = torch.from_numpy(t_combos).to(dev)
    decode_cases.append((f"bd8 C={C} {R}x{H}x{W} sorted (timed)", t_refs,
                         t_combos, 8))
    edge = [(lbl, torch.from_numpy(r).to(dev), c, bd)
            for lbl, r, c, bd in hplanes_edge_cases(rng, np)]
    # reference rows off the 16-byte grid: a view one element into its
    # allocation
    flat = torch.from_numpy(rng.integers(
        0, 256, 2 * 6 * 1920 + 1, dtype=np.int32)).to(dev)
    edge.append(("refs 4 bytes off 16-byte alignment",
                 flat[1:].view(2, 6, 1920), _hp_combos(rng, np, 2, 9, True),
                 8))
    hp_all = [(lbl, r, torch.from_numpy(c).to(dev), bd)
              for lbl, r, c, bd in decode_cases + edge]

    max_err = 0
    for lbl, refs, combos_t, bd in hp_all:
        max_err = max(max_err, check_hp(refs, combos_t, bd, lbl))

    def run_hp():
        return mc_cuda.mc_hplanes(t_refs, t_combos_d, 8)
    k_ms = time_warm(torch, run_hp, 50)
    k_cold = time_cold(torch, run_hp, scratch, 20)
    # the decode's own largest call: its reference planes and combos
    own_refs, own_combos, own_bd = shapes.hplanes_args
    max_err = max(max_err, check_hp(own_refs, own_combos, own_bd,
                                    "the decode's own largest call"))

    def run_own_hp():
        return mc_cuda.mc_hplanes(own_refs, own_combos, own_bd)
    own_hp = (time_warm(torch, run_own_hp, 50),
              time_cold(torch, run_own_hp, scratch, 20))
    o_r, o_h, o_w = own_refs.shape
    o_c = own_combos.shape[0]
    n_own = len(torch.unique(own_combos[:, 0]))
    b_own, _ = bound(n_own * o_h * o_w * 4 + o_c * 3 * 4 +
                     o_c * o_h * (o_w + 22) * 2, o_c * o_h * (o_w + 22) * 16)
    print(f"  mc_hplanes on the decode's own largest call (R={o_r} H={o_h} "
          f"W={o_w} C={o_c}, {n_own} refs used): {own_hp[0]:.5f} ms warm, "
          f"{own_hp[1]:.5f} ms cold, bound {b_own:.5f} ms")
    p_ms, p_wall = time_plain(
        torch, lambda: mc.mc_hplanes(t_refs, t_combos_d, 8), 5)
    n_used = len(np.unique(t_combos[:, 0]))
    b_ms, b_by = bound(n_used * H * W * 4 + C * 3 * 4 + C * H * (W + 22) * 2,
                       C * H * (W + 22) * 16)
    rows.append(dict(
        name="mc_hplanes", route="cuda",
        source="dav1d_mirror_tpu_torch/csrc/mc_hplanes.cu",
        replaces="dav1d_mirror_tpu/ops/mc_pallas.py:226",
        launches=None, max_abs_err=max_err, ms=k_ms, plain_ms=p_ms,
        plain_wall_ms=p_wall, bound_ms=b_ms, bound_by=b_by, library_ms=None, cold_ms=k_cold,
        floor_ms=floor_ms,
        cases=[c[0] for c in hp_all],
        shape=f"R={R} H={H} W={W} C={C} sorted combos over {n_used} refs "
              f"bd=8"))

    # ---- V-pass kernel: every unit size the decode used (and the four
    # of 4 and 8 pixels) at its largest decode batch, then the edges ----
    by_unit = {}
    for B, uw, uh, Cs, Hs, w_mid, _ in shapes.vpass:
        if B > by_unit.get((uw, uh), (0,))[0]:
            by_unit[(uw, uh)] = (B, Cs, Hs, w_mid)
    biggest = max(by_unit.values())
    for unit in ((8, 8), (8, 4), (4, 8), (4, 4)):
        by_unit.setdefault(unit, biggest)
    vp_cases = []
    max_err = 0
    main_unit = max(by_unit, key=lambda u: by_unit[u][0])

    def check_vp(args, uw, uh, bd, prep, label):
        got = mc_cuda.mc_unit_batch_hv(args, uw, uh, bd, prep)
        want = mc.mc_unit_batch_hv(args, uw, uh, bd, prep)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (
            f"mc_vpass differs from its plain version: {label} "
            f"{'prep' if prep else 'put'}")
        vp_cases.append(f"{label} {'prep' if prep else 'put'}")
        return int((got - want).abs().max())

    timed = None
    for (uw, uh), (B, Cs, Hs, w_mid) in sorted(by_unit.items()):
        Wd = w_mid - 22
        for bd in (8, 10, 12):
            hstack = torch.from_numpy(rng.integers(
                -(1 << 14), 1 << 14, (Cs, Hs, w_mid),
                dtype=np.int16)).to(dev)
            cols = [rng.integers(0, Cs, B), rng.integers(-40, Hs + 30, B),
                    rng.integers(-15, Wd, B), rng.integers(1, 16, B),
                    rng.integers(0, 3, B)]
            cols = [torch.from_numpy(c.astype(np.int32)).to(dev)
                    for c in cols]
            args = (hstack, *cols)
            for prep in (False, True):
                max_err = max(max_err, check_vp(
                    args, uw, uh, bd, prep, f"{uw}x{uh} bd{bd} B={B}"))
            if bd == 8:
                def run_vp(args=args, uw=uw, uh=uh):
                    return mc_cuda.mc_unit_batch_hv(args, uw, uh, 8, False)
                warm = time_warm(torch, run_vp, 100)
                cold = time_cold(torch, run_vp, scratch, 20)
                print(f"  mc_vpass {uw}x{uh} B={B} bd8 put: {warm:.5f} ms "
                      f"warm, {cold:.5f} ms cold")
                if (uw, uh) == main_unit:
                    timed = (args, uw, uh, B, warm, cold)
    for lbl, args, uw, uh, bd in vpass_edge_cases(rng, np, torch, dev):
        for prep in (False, True):
            max_err = max(max_err, check_vp(args, uw, uh, bd, prep, lbl))
    args, uw, uh, B, k_ms, k_cold = timed
    # the same bucket on the decode's own descriptors and H-planes (units
    # of a block sit side by side, so their windows share sectors)
    own, own_bd = shapes.vpass_args[(uw, uh)]
    max_err = max(max_err, check_vp(
        own, uw, uh, own_bd, False,
        f"{uw}x{uh} decode's own B={own[1].shape[0]}"))

    def run_own():
        return mc_cuda.mc_unit_batch_hv(own, uw, uh, own_bd, False)
    own_ms = (time_warm(torch, run_own, 100),
              time_cold(torch, run_own, scratch, 20))
    b_own, _ = bound(own[1].shape[0] * ((uh + 7) * uw * 2 + 5 * 4 +
                                        uh * uw * 4),
                     own[1].shape[0] * uh * uw * 16)
    print(f"  mc_vpass {uw}x{uh} B={own[1].shape[0]} bd8 put, the decode's "
          f"own descriptors: {own_ms[0]:.5f} ms warm, {own_ms[1]:.5f} ms "
          f"cold, bound {b_own:.5f} ms")
    p_ms, p_wall = time_plain(torch, lambda: mc.mc_unit_batch_hv(
        args, uw, uh, 8, False), 10)
    b_ms, b_by = bound(B * ((uh + 7) * uw * 2 + 5 * 4 + uh * uw * 4),
                       B * uh * uw * 16)
    rows.append(dict(
        name="mc_vpass", route="cuda",
        source="dav1d_mirror_tpu_torch/csrc/mc_vpass.cu",
        replaces="dav1d_mirror_tpu/ops/mc_pallas.py:41",
        launches=None, max_abs_err=max_err, ms=k_ms, plain_ms=p_ms,
        plain_wall_ms=p_wall, bound_ms=b_ms, bound_by=b_by, library_ms=None, cold_ms=k_cold,
        floor_ms=floor_ms, cases=vp_cases,
        shape=f"B={B} unit={uw}x{uh} C={args[0].shape[0]} bd=8 put"))
    return rows


def own_calls_phase(torch, mc, mc_cuda, shapes, path, rows):
    """Each kernel against its plain version (torch.equal) on a decode's
    own calls, as the decode made them: its largest H-plane call, its
    largest on a chroma plane, and its largest put V-pass call of each
    unit size. Adds the cases to the kernel rows."""
    by_name = {r["name"]: r for r in rows}
    row = by_name["mc_hplanes"]
    for what, (refs, combos, bd) in (
            ("own largest call", shapes.hplanes_args),
            ("own largest chroma call", shapes.hplanes_chroma_args)):
        got = mc_cuda.mc_hplanes(refs, combos, bd)
        want = mc.mc_hplanes(refs, combos, bd)
        torch.cuda.synchronize()
        label = (f"{path} {what} R={refs.shape[0]} "
                 f"{refs.shape[1]}x{refs.shape[2]} C={combos.shape[0]} "
                 f"bd{bd}")
        assert torch.equal(got, want), f"mc_hplanes differs: {label}"
        row["cases"].append(label)
        row["max_abs_err"] = max(row["max_abs_err"], int(
            (got.to(torch.int32) - want.to(torch.int32)).abs().max()))
    row = by_name["mc_vpass"]
    for (uw, uh), (args, bd) in sorted(shapes.vpass_args.items()):
        got = mc_cuda.mc_unit_batch_hv(args, uw, uh, bd, False)
        want = mc.mc_unit_batch_hv(args, uw, uh, bd, False)
        torch.cuda.synchronize()
        label = f"{path} own {uw}x{uh} B={args[1].shape[0]} bd{bd} put"
        assert torch.equal(got, want), f"mc_vpass differs: {label}"
        row["cases"].append(label)
        row["max_abs_err"] = max(row["max_abs_err"],
                                 int((got - want).abs().max()))


def mcu_check(torch, mc, mcu_cuda, fn, dst, args, label):
    """One unit MC kernel call against its plain version on clones of
    the destination `dst` (torch.equal). Returns the max abs error."""
    got = getattr(mcu_cuda, fn)(dst.clone(), *args)
    want = getattr(mc, fn)(dst.clone(), *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want), \
        f"{fn} differs from its plain version: {label}"
    return int((got - want).abs().max())


def mcu_synthetic_cases(np, torch, rng, dev):
    """(fn, label, destination, args) of the unit MC kernels' synthetic
    cases on `dev` (inputs from tools/mcu_cases): bd 8/10/12 x the four
    (has_h, has_v) cases x put and prep x MCU_UNITS, each into a plane
    (units on a grid whose last row and column the plane's edge cuts,
    three pad rows: int16 descriptors with OOB16 or int32 with PAD_OOB,
    by unit) and into whole slots (pad rows repeating the last unit and
    slot); scaled: bd 8/10/12 x put and prep x MCS_UNITS into a plane and
    at flat offsets of 8x8-cell slots, steps 512..2048 with subpel-0
    columns and rows, plus a strided reference view. Small units come 300
    to a bucket (several CTAs, the last one partial)."""
    from dav1d_mirror_tpu_torch.models.frame_exec import OOB16
    from dav1d_mirror_tpu_torch.tools.mcu_cases import (
        grid_origins, pad_dup, scaled_rows, slot_bases, unit_rows)

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    cases = []
    for bd in (8, 10, 12):
        refs = rng.integers(0, 1 << bd, (3, 70, 150)).astype(np.int32)
        refs_t = T(refs)
        for hh, hv in ((0, 0), (1, 0), (0, 1), (1, 1)):
            for prep in (False, True):
                for k, (uw, uh) in enumerate(MCU_UNITS):
                    small = uw * uh <= 64
                    n = 300 if small else 12
                    gy, gx = (17, 21) if small else (4, 4)
                    H, W = (gy - 1) * uh + uh // 2 + 1, \
                        (gx - 1) * uw + uw // 2 + 1
                    arr = pad_dup(unit_rows(rng, n, refs.shape, uw, uh), 3)
                    ys, xs = grid_origins(rng, n + 3, uw, uh, H, W, 3)
                    narrow = k % 2 == 0
                    if narrow:
                        ys[-3:] = OOB16
                    dt = np.int16 if narrow else np.int32
                    plane = T(rng.integers(0, 1 << bd, (H, W)).astype(
                        np.int32))
                    tag = (f"bd{bd} h{hh}v{hv} {'prep' if prep else 'put'} "
                           f"{uw}x{uh}")
                    cases.append((
                        "mc_units_plane",
                        f"{tag} B={n}+3 plane {H}x{W} "
                        f"{'int16/OOB16' if narrow else 'int32/PAD_OOB'}",
                        plane, (refs_t, T(arr.astype(dt)), T(ys.astype(dt)),
                                T(xs.astype(dt)), uw, uh, bool(hh),
                                bool(hv), bd, prep)))
                    N = 80 if small else 8
                    ns = N - 10 if small else 5
                    slots = pad_dup(rng.permutation(N - 1)[:ns].astype(
                        np.int32), 3)
                    arr = pad_dup(unit_rows(rng, ns, refs.shape, uw, uh), 3)
                    cases.append((
                        "mc_units_slots", f"{tag} B={ns}+3 slots N={N}",
                        T(np.zeros((N, uh, uw), np.int32)),
                        (refs_t, T(arr), T(slots), bool(hh), bool(hv), bd,
                         prep)))
        srefs = rng.integers(0, 1 << bd, (2, 60, 90)).astype(np.int32)
        srefs_t = T(srefs)
        for prep in (False, True):
            for uw, uh in MCS_UNITS:
                small = uw * uh <= 64
                n = 300 if small else 12
                gy, gx = (17, 21) if small else (4, 4)
                H, W = (gy - 1) * uh + 1, (gx - 1) * uw + 3
                rows = pad_dup(scaled_rows(rng, n, srefs.shape, uw, uh), 3)
                ys, xs = grid_origins(rng, n + 3, uw, uh, H, W, 3)
                tag = f"bd{bd} {'prep' if prep else 'put'} {uw}x{uh}"
                plane = T(rng.integers(0, 1 << bd, (H, W)).astype(np.int32))
                cases.append(("mc_scaled_plane",
                              f"scaled {tag} B={n}+3 plane {H}x{W}", plane,
                              (srefs_t, T(rows), T(ys), T(xs), uw, uh, bd,
                               prep)))
                # sub-rect writes into slots of whole 8x8 cells
                bwp, bhp = max(uw, 8), max(uh, 8)
                N = 40 if small else 4
                base = pad_dup(slot_bases(N, bwp, bhp, uw, uh)[:n], 3)
                rows = pad_dup(scaled_rows(rng, len(base) - 3, srefs.shape,
                                           uw, uh), 3)
                cases.append(("mc_scaled_slots",
                              f"scaled {tag} B={len(base) - 3}+3 slots "
                              f"{N}x{bhp}x{bwp}",
                              T(np.zeros((N, bhp, bwp), np.int32)),
                              (srefs_t, T(rows), T(base), uw, uh, bd,
                               prep)))
    # a scaled reference is a crop [:h, :w] of a wider plane, read in
    # place at its strides
    full = T(rng.integers(0, 256, (1, 66, 99)).astype(np.int32))
    view = full[:, :50, :80]
    rows = scaled_rows(rng, 64, view.shape, 8, 8)
    ys, xs = grid_origins(rng, 64, 8, 8, 72, 72, 0)
    cases.append(("mc_scaled_plane", "scaled bd8 put 8x8 strided view",
                  T(np.zeros((72, 72), np.int32)),
                  (view, T(rows), T(ys), T(xs), 8, 8, 8, False)))
    return cases


def mcu_own_case(torch, kept, bd_of):
    """(destination, args) to replay a ShapeLog.mcu record: the kept
    descriptors and references, a destination of the kept shape filled
    with pixels of the call's bit depth."""
    (shape, dtype), args = kept["dst"], kept["args"]
    dev = args[0].device
    g = torch.Generator(device=dev).manual_seed(len(shape) * 7)
    dst = torch.randint(0, 1 << bd_of(args), shape, dtype=dtype,
                        device=dev, generator=g)
    return dst, args


def _mcu_bd(kind):
    """The bit depth's position among a wrapper's arguments after the
    destination (MCU_KINDS)."""
    return {"put": 8, "t": 5, "scaled": 6, "s": 5}[kind]


def mcu_own_calls(torch, mc, mcu_cuda, shapes, path, rows):
    """Each unit MC kernel against its plain version (torch.equal) on a
    path's own largest one-entry call of each record kind (the
    tile-sharded decode's). Adds the cases to the kernel rows."""
    by_name = {r["name"]: r for r in rows}
    for kind, kept in sorted(shapes.mcu.items()):
        fn = MCU_KINDS[kind]
        row = by_name["mc_scaled" if kind in ("scaled", "s") else
                      "mc_units"]
        dst, args = mcu_own_case(torch, kept, lambda a: a[_mcu_bd(kind)])
        uw, uh = mcu_unit(kind, dst, args[2:])
        label = (f"{path} own one-entry {kind} B={args[1].shape[0]} "
                 f"{uw}x{uh} into {tuple(dst.shape)} "
                 f"bd{args[_mcu_bd(kind)]}")
        err = mcu_check(torch, mc, mcu_cuda, fn, dst, args, label)
        row["cases"].append(label)
        row["max_abs_err"] = max(row["max_abs_err"], err)


def mcu_run_args(torch, np, call, rng):
    """The arguments of a recorded run (McuLog) in the order of
    ops/mcu_cuda.mc_units_run / mc_scaled_run: its table and buffers,
    planes of its shapes filled with pixels of its bit depth, its
    references and a zero arena of its size."""
    dev = call["tab"].device
    planes = [torch.from_numpy(rng.integers(0, 1 << call["bd"], sh).astype(
        np.int32)).to(dev) for sh, _ in call["planes"]]
    arena = torch.zeros(call["arena_n"], dtype=torch.int32, device=dev)
    return (call["tab"], call["work"], *call["bufs"], planes, call["refs"],
            arena)


def mcu_run_compare(torch, mc, mcu_cuda, kind, args, bd, label):
    """A unit MC run kernel against its plain version (torch.equal) on
    clones of the planes and arena of `args` (mcu_run_args). Returns
    the max abs difference (0)."""
    def fresh():
        return args[:-3] + ([p.clone() for p in args[-3]], args[-2],
                            args[-1].clone())
    got, want = fresh(), fresh()
    getattr(mcu_cuda, MCU_RUNS[kind])(*got, bd)
    getattr(mc, MCU_RUNS[kind])(*want, bd)
    torch.cuda.synchronize()
    pairs = list(zip(got[-3] + [got[-1]], want[-3] + [want[-1]]))
    assert all(torch.equal(g, w) for g, w in pairs), \
        f"{MCU_RUNS[kind]} differs from its plain version: {label}"
    return max([int((g - w).abs().max()) for g, w in pairs if g.numel()]
               + [0])


def run_entry_calls(mc, kind, args, bd):
    """[(record kind, destination, wrapper args)]: the one-entry calls
    (MCU_KINDS) that the entries of a run stand for, on every row (pad
    rows included, as one launch a record ran them); descriptors views
    of the run's buffers, destinations its planes or views of its arena.
    args: mcu_run_args."""
    tab, work = args[0], args[1]
    *bufs, planes, refs, arena = args[2:]
    d32, d16 = bufs[0], bufs[-1]
    out = []
    for e in mc.mc_table_entries(tab, work[0]):
        fl, B, uw, uh = e[mc.M_FLAGS], e[mc.M_B], e[mc.M_UW], e[mc.M_UH]

        def sl(f, flag, n, e=e, fl=fl):
            return (d16 if fl & flag else d32)[e[f]:e[f] + n]
        ref, prep = refs[e[mc.M_REF]], bool(fl & mc.MF_PREP)
        slot = arena[e[mc.M_DST]:e[mc.M_DST] + e[mc.M_DSTN]]
        if kind == "mcurun":
            arr = sl(mc.M_DESC, mc.MF_DESC16, 6 * B).view(B, 6)
            ys = sl(mc.M_YS, mc.MF_YS16, B)
            hv = (bool(fl & mc.MF_H), bool(fl & mc.MF_V))
            if fl & mc.MF_ARENA:
                out.append(("t", slot.view(-1, uh, uw),
                            (ref, arr, ys, *hv, bd, prep)))
            else:
                out.append(("put", planes[e[mc.M_PLANE]],
                            (ref, arr, ys, sl(mc.M_XS, mc.MF_XS16, B), uw,
                             uh, *hv, bd, prep)))
        else:
            rows = sl(mc.M_DESC, 0, 9 * B).view(B, 9)
            ys = sl(mc.M_YS, 0, B)
            if fl & mc.MF_ARENA:
                out.append(("s", slot.view(1, -1, e[mc.M_ROWW]),
                            (ref, rows, ys, uw, uh, bd, prep)))
            else:
                out.append(("scaled", planes[e[mc.M_PLANE]],
                            (ref, rows, ys, sl(mc.M_XS, 0, B), uw, uh, bd,
                             prep)))
    return out


def _taps_nz(np, mc, ftype, sub, small):
    """(..., 8) bool: the nonzero taps of the subpel filters of `ftype`
    (0..2) at subpel `sub` (1..15), 4-tap rows where `small`."""
    row = np.where(small, 3 + (ftype & 1), ftype)
    return mc.SUBPEL[row, np.clip(sub, 1, 15) - 1] != 0


def _tap_need(np, off, nz, n):
    """(B, n) bool: the window positions that the taps `nz` (B, m, 8)
    at offsets `off` (B, m) read, clamped into [0, n) as the gathers
    clamp them."""
    need = np.zeros((off.shape[0], n), bool)
    idx = np.clip(off[:, :, None] + np.arange(8), 0, n - 1)
    b = np.broadcast_to(np.arange(off.shape[0])[:, None, None], idx.shape)
    need[b[nz], idx[nz]] = True
    return need


def _mark(np, mask, ref, org_y, need_r, org_x, need_c):
    """Set in `mask` (R, H, W) the reference pixels the units read: unit
    b reads the rows clamp(org_y[b] + r) with need_r[b, r] at the columns
    clamp(org_x[b] + c) with need_c[b, c] of reference ref[b]."""
    R, H, W = mask.shape
    rows = np.clip(org_y[:, None] + np.arange(need_r.shape[1]), 0, H - 1)
    cols = np.clip(org_x[:, None] + np.arange(need_c.shape[1]), 0, W - 1)
    for b in range(len(ref)):
        mask[ref[b], rows[b][need_r[b]][:, None], cols[b][need_c[b]]] = True


def _touched(np, shape, ref, org_y, need_r, org_x, need_c):
    """Reference pixels the units read, each counted once (_mark)."""
    mask = np.zeros(shape, bool)
    _mark(np, mask, ref, org_y, need_r, org_x, need_c)
    return int(mask.sum())


def _mcu_reads(np, mc, kind, dst, args):
    """What one unit MC call reads and writes: (ref, org_y, need_r,
    org_x, need_c) of _mark over its real units, the bytes of their
    descriptors and origins and of the pixels written inside the
    destination (pad rows write nothing; duplicate slots count once),
    the operations (16 a tap pass output on the rows that pass needs)
    and the real units."""
    uw, uh = mcu_unit(kind, dst, args[2:])
    desc = args[1].cpu().numpy().astype(np.int64)
    esz = args[1].element_size()
    if kind in ("put", "scaled"):
        ys = args[2].cpu().numpy().astype(np.int64)
        xs = args[3].cpu().numpy().astype(np.int64)
        H, W = dst.shape
        rows_in = np.clip(np.minimum(ys + uh, H) - np.maximum(ys, 0), 0,
                          None)
        cols_in = np.clip(np.minimum(xs + uw, W) - np.maximum(xs, 0), 0,
                          None)
        written = rows_in * cols_in
        real = written > 0
        origin = 2 * args[2].element_size()
    else:
        slots = args[2].cpu().numpy()
        real = np.zeros(len(slots), bool)
        real[np.unique(slots, return_index=True)[1]] = True
        written = np.full(len(slots), uh * uw)
        origin = args[2].element_size()
    d = desc[real]
    B = len(d)
    if kind in ("put", "t"):
        # output y of a filtered axis reads window positions y + k
        hh, hv = (args[6], args[7]) if kind == "put" else (args[3], args[4])
        f2d = mc._F2D[np.clip(d[:, 5], 0, 8)]
        need = []
        for on, n, t, sub in ((hv, uh, f2d[:, 1], d[:, 4]),
                              (hh, uw, f2d[:, 0], d[:, 3])):
            if not on:
                need.append(np.ones((B, n), bool))
                continue
            nz = _taps_nz(np, mc, t, sub, n <= 4)[:, None]
            need.append(_tap_need(np, np.broadcast_to(np.arange(n), (B, n)),
                                  np.broadcast_to(nz, (B, n, 8)), n + 7))
        need_r, need_c = need
        org_y, org_x = d[:, 1], d[:, 2]
        ops = need_r.sum(1) * uw * 16 * hh + uh * uw * 16 * hv
        n_desc = 6
    else:
        # output y reads mid rows (phy >> 10) + k, a copy phase k = 3 only
        f2d = mc._F2D[np.clip(d[:, 7], 0, 8)]
        need = []
        for f, step, n, t in ((d[:, 4], d[:, 6], uh, f2d[:, 1]),
                              (d[:, 3], d[:, 5], uw, f2d[:, 0])):
            ph = f[:, None] + np.arange(n) * step[:, None]
            sub = (ph & 0x3FF) >> 6
            nz = _taps_nz(np, mc, t[:, None], sub, n <= 4)
            nz = np.where((sub == 0)[:, :, None], np.arange(8) == 3, nz)
            need.append(_tap_need(np, ph >> 10, nz, 2 * n + 10))
        need_r, need_c = need
        org_y, org_x = d[:, 1] - 3, d[:, 2] - 3
        ops = need_r.sum(1) * uw * 16 + uh * uw * 16
        n_desc = 9
    other = float(np.sum(real * (n_desc * esz + origin +
                                 written * dst.element_size())))
    return ((d[:, 0], org_y, need_r, org_x, need_c), other,
            float(np.sum(ops)), int(real.sum()))


def mcu_bound(np, mc, kind, dst, args):
    """(least ms, what bounds it, real units) of one unit MC call at the
    H100's rates. Bytes: the reference pixels that the real units' taps
    read (nonzero taps only, 4-tap rows for sides <= 4, copy phases one
    tap; overlapping windows counted once), their descriptors and
    origins, and the pixels written inside the destination (_mcu_reads).
    Operations: 16 a tap pass output on the rows that pass needs."""
    reads, other, ops, real = _mcu_reads(np, mc, kind, dst, args)
    px = _touched(np, tuple(args[0].shape), *reads)
    ms, by = bound(px * args[0].element_size() + other, ops)
    return ms, by, real


def mcu_run_bound(np, mc, kind, args, bd):
    """(least ms, what bounds it, real units, entries) of one run
    (mcu_run_args): its entries' _mcu_reads, each reference pixel that
    any real unit's taps read counted once for each reference, and the
    table read once."""
    masks = {}
    n_bytes, n_ops, n_real = 4.0 * args[0].numel(), 0.0, 0
    calls = run_entry_calls(mc, kind, args, bd)
    for rk, dst, a in calls:
        reads, other, ops, real = _mcu_reads(np, mc, rk, dst, a)
        mask = masks.setdefault(id(a[0]), np.zeros(tuple(a[0].shape), bool))
        _mark(np, mask, *reads)
        n_bytes, n_ops, n_real = n_bytes + other, n_ops + ops, n_real + real
    n_bytes += 4 * sum(int(m.sum()) for m in masks.values())
    ms, by = bound(n_bytes, n_ops)
    return ms, by, n_real, len(calls)


def time_entries(torch, calls, mcu_cuda):
    """Device ms of a run's entries as one-entry launches (run_entry_
    calls, every row), QUEUE_LAUNCHES a timing, the timings summed."""
    total = 0.0
    for i in range(0, len(calls), QUEUE_LAUNCHES):
        chunk = calls[i:i + QUEUE_LAUNCHES]

        def run(chunk=chunk):
            for rk, dst, a in chunk:
                getattr(mcu_cuda, MCU_KINDS[rk])(dst, *a)
        reps = max(1, QUEUE_LAUNCHES // len(chunk))
        total += time_warm(torch, run, reps)
    return total


def mcu_timed_run(torch, np, mc, mcu_cuda, kind, call, scratch, label,
                  rng, plain=True):
    """Time one recorded run (McuLog) of `kind` on the card: warm and
    cold, in turns with its entries as one-entry launches (one-entry,
    run, run, one-entry), against its byte bound; with `plain`, its
    plain version's device and wall time (one call: it issues tens of
    thousands of ops); its largest entry (by outputs, pad rows included)
    as a one-entry launch, warm and cold, against that call's bound.
    Prints them; returns a dict of the numbers."""
    bd = call["bd"]
    args = mcu_run_args(torch, np, call, rng)
    work = call["work"]
    calls = run_entry_calls(mc, kind, args, bd)

    def run_k():
        return getattr(mcu_cuda, MCU_RUNS[kind])(*args, bd)

    def run_p():
        return getattr(mc, MCU_RUNS[kind])(*args, bd)
    turns = [time_entries(torch, calls, mcu_cuda),
             time_warm(torch, run_k, 100), time_warm(torch, run_k, 100),
             time_entries(torch, calls, mcu_cuda)]
    warm = min(turns[1:3])
    cold = time_cold(torch, run_k, scratch, 20)
    p_ms, p_wall = time_plain(torch, run_p, 1) if plain else (None, None)
    b_ms, b_by, n_real, n_ent = mcu_run_bound(np, mc, kind, args, bd)
    smem = 4 * (2 * work[2] + work[3])
    shape = (f"{label}: {work[0]} entries, {n_real} real units, "
             f"{work[1]} items, bd{bd}, dynamic shared memory {smem} bytes "
             f"a CTA (two stages of {work[2]} ints, mid {work[3]}), arena "
             f"{4 * call['arena_n']} bytes")
    print(f"  {MCU_RUNS[kind]} {shape}: {warm:.5f} ms warm, {cold:.5f} ms "
          f"cold, " + (f"plain {p_ms:.5f} ms device, {p_wall:.5f} ms wall, "
                       if plain else "") +
          f"bound {b_ms:.5f} ms ({b_by}), {100 * b_ms / warm:.1f}% of "
          f"bound warm")
    print(f"  {MCU_RUNS[kind]} {label}: the same {n_ent} entries as "
          f"one-entry launches, in turns (one-entry, run, run, one-entry): "
          + ", ".join(f"{t:.5f}" for t in turns) +
          f" ms; one-entry / run {min(turns[0], turns[3]) / warm:.1f}x")
    # its largest entry as a one-entry launch
    rk, dst, a = max(calls, key=lambda c: c[2][1].shape[0] * int(np.prod(
        mcu_unit(c[0], c[1], c[2][2:]))))
    uw, uh = mcu_unit(rk, dst, a[2:])
    fn = getattr(mcu_cuda, MCU_KINDS[rk])
    o_warm = time_warm(torch, lambda: fn(dst, *a), 100)
    o_cold = time_cold(torch, lambda: fn(dst, *a), scratch, 20)
    o_ms, o_by, o_real = mcu_bound(np, mc, rk, dst, a)
    print(f"  {MCU_KINDS[rk]} {label}'s largest {rk} bucket as a one-entry "
          f"launch: B={a[1].shape[0]} ({o_real} real) {uw}x{uh}: "
          f"{o_warm:.5f} ms warm, {o_cold:.5f} ms cold, bound {o_ms:.5f} ms "
          f"({o_by}), {100 * o_ms / o_warm:.1f}% of bound warm")
    return dict(ms=warm, cold_ms=cold, bound_ms=b_ms, bound_by=b_by,
                plain_ms=p_ms, plain_wall_ms=p_wall, shape=shape,
                one_entry_ms=turns, largest=dict(
                    kind=rk, B=a[1].shape[0], real=o_real, warm=o_warm,
                    cold=o_cold, bound=o_ms))


def mcu_phase(torch, np, mc, mcu_cuda, owned, scratch, floor_ms):
    """The two unit MC kernels against their plain versions on the card
    (torch.equal): mixed synthetic runs (tools/mcu_cases: every unit
    size, (has_h, has_v), put and prep, descriptor width, plane and arena
    destinations, pad rows, edge-cut units, scaled steps; bd 8/10/12,
    MCU_RUN_SEEDS seeds), the one-entry synthetic cases
    (mcu_synthetic_cases), each path's own largest run of each kind and
    the one-entry calls of the paths that make them (`owned` {path:
    ShapeLog or McuLog}: the tile-sharded decode's). Then times config 2
    frame 3's mcurun (the mc_units row), super-res frame 4's mcsrun (the
    mc_scaled row) and the tools path's frame 2 mcurun (its plain version
    not timed), each against its byte bound and its entries as one-entry
    launches (mcu_timed_run).
    Returns the two kernel rows."""
    from dav1d_mirror_tpu_torch.tools import mcu_cases
    dev = torch.device("cuda")
    rng = np.random.default_rng(2031)
    rows = {name: dict(name=name, route="cuda", cases=[], max_abs_err=0,
                       launches=None, library_ms=None, floor_ms=floor_ms)
            for name in ("mc_units", "mc_scaled")}
    rows["mc_units"].update(
        source="dav1d_mirror_tpu_torch/csrc/mc_units.cu",
        replaces="dav1d_mirror_tpu/ops/mc_tpu.py:53 (mc_unit_batch, with "
                 "scatter_units :266 or set_slots :310 after it; XLA-fused "
                 "on the TPU, not a Pallas kernel)")
    rows["mc_scaled"].update(
        source="dav1d_mirror_tpu_torch/csrc/mc_scaled.cu",
        replaces="dav1d_mirror_tpu/ops/mc_tpu.py:473 (mc_scaled_batch, "
                 "with scatter_units :266 or scatter_slot_units :316 after "
                 "it; XLA-fused on the TPU, not a Pallas kernel)")

    def note(kind, label, err):
        row = rows[MCU_ROW[kind]]
        row["cases"].append(label)
        row["max_abs_err"] = max(row["max_abs_err"], err)
    t0 = time.perf_counter()
    for seed in range(MCU_RUN_SEEDS):
        for bd in (8, 10, 12):
            for kind, make, units in (
                    ("mcurun", mcu_cases.units_run_case, MCU_UNITS),
                    ("mcsrun", mcu_cases.scaled_run_case, MCS_UNITS)):
                case = make(rng, bd, units)
                label = (f"mixed run seed {seed} bd{bd}: {case['work'][0]} "
                         f"entries, {case['work'][1]} items")
                note(kind, label, mcu_run_compare(
                    torch, mc, mcu_cuda, kind,
                    mcu_cases.run_case_args(case, dev), bd, label))
    n_runs = sum(len(r["cases"]) for r in rows.values())
    for fn, label, dst, args in mcu_synthetic_cases(np, torch, rng, dev):
        kind = "mcsrun" if "scaled" in fn else "mcurun"
        note(kind, f"one-entry {label}", mcu_check(
            torch, mc, mcu_cuda, fn, dst, args, label))
    print(f"  unit MC synthetic cases: {n_runs} mixed runs and "
          f"{sum(len(r['cases']) for r in rows.values()) - n_runs} "
          f"one-entry cases, all torch.equal "
          f"({time.perf_counter() - t0:.1f} s)")
    n_own = 0
    t0 = time.perf_counter()
    for path, shapes in owned.items():
        for kind, call in sorted(shapes.runs.items() if isinstance(
                shapes, McuLog) else shapes.mcu_runs.items()):
            label = (f"{path} own largest {kind}: {call['work'][0]} "
                     f"entries, {call['work'][1]} items, bd{call['bd']}")
            note(kind, label, mcu_run_compare(
                torch, mc, mcu_cuda, kind,
                mcu_run_args(torch, np, call, rng), call["bd"], label))
            n_own += 1
        mcu_own_calls(torch, mc, mcu_cuda, shapes, path, list(rows.values()))
        n_own += len(shapes.mcu)
    print(f"  unit MC own calls: {n_own} cases on {len(owned)} paths "
          f"({', '.join(owned)}), all torch.equal "
          f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    for path, kind, frame, name in (
            ("config 2", "mcurun", OPS_FRAME, "mc_units"),
            ("tools", "mcurun", TOOLS_RUN_FRAME, None),
            ("superres", "mcsrun", SR_OPS_FRAME, "mc_scaled")):
        got = mcu_timed_run(torch, np, mc, mcu_cuda, kind,
                            owned[path].mcu_kept(kind), scratch,
                            f"{path} frame {frame}'s {kind}", rng,
                            plain=name is not None)
        if name:
            rows[name].update(got)
    print(f"  unit MC timings: {time.perf_counter() - t0:.1f} s")
    return [rows["mc_units"], rows["mc_scaled"]]


def filter_plain():
    """{wrapper: its plain version} of FILTER_FNS."""
    from dav1d_mirror_tpu_torch.ops import cdef, loopfilter
    return {"deblock_frame": loopfilter.deblock_frame,
            "deblock_plane": loopfilter.deblock_plane,
            "apply_pass": loopfilter._apply_pass,
            "cdef_frame": cdef.cdef_frame,
            "cdef_filter_plane": cdef.cdef_filter_plane,
            "cdef_dir": cdef.cdef_dir}


def filter_compare(torch, name, args, kwargs):
    """A deblock or CDEF wrapper and its plain version on copies of one
    call's arguments (apply_pass writes its rows): torch.equal required.
    Returns the max abs difference (0)."""
    from dav1d_mirror_tpu_torch.ops import cdef_cuda, deblock_cuda
    mod = deblock_cuda if FILTER_FNS[name] == "deblock" else cdef_cuda
    a_k, a_p = _clone(args), _clone(args)
    got = getattr(mod, name)(*a_k, **_clone(kwargs))
    want = filter_plain()[name](*a_p, **_clone(kwargs))
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want) and all(
        torch.equal(g, w) for g, w in zip(got, want)), \
        f"{name} differs from its plain version"
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               if g.numel() else 0 for g, w in zip(got, want))


def _describe(name, args, kwargs):
    """A call's plane shapes, for a case label."""
    first = _first(args, kwargs)
    if isinstance(first, (tuple, list)):
        return f"planes {', '.join(str(tuple(p.shape)) for p in first)}"
    return f"plane {tuple(first.shape)} {first.dtype}, strides " \
        f"{first.stride()}"


def deblock_cost(np, args, kwargs):
    """(bytes, operations) one deblock_plane call needs: the int32 plane
    read once and the result written once, its six maps and the LUTs
    read; the active edge rows of both passes evaluate DBK_EDGE_OPS. The
    pass kernel's two launches move the plane twice (the vertical pass's
    output is the horizontal pass's input): that second round trip is
    the design's, not the function's, and is not counted."""
    a = list(args) + [kwargs[k] for k in ("luma", "bitdepth")
                      if k in kwargs]
    plane, maps, (e_lut, i_lut), luma = a[0], a[1:7], a[7:9], a[9]
    n_bytes = 2 * 4 * plane.numel() + sum(
        m.numel() * m.element_size() for m in maps) + \
        e_lut.numel() * e_lut.element_size() + \
        i_lut.numel() * i_lut.element_size()
    ev, eh, lv, lvp, lh, lhp = (m.cpu().numpy() for m in maps)
    rows = 0
    # x = 0 has no vertical edge, y = 0 no horizontal one
    for e, lc, lp, first in ((ev, lv, lvp, (slice(None), 0)),
                             (eh, lh, lhp, (0, slice(None)))):
        act = (e >= 0) & (np.where(lc != 0, lc, lp) != 0)
        act[first] = False
        rows += 4 * int(act.sum())
    return n_bytes, rows * DBK_EDGE_OPS[bool(luma)]


def deblock_frame_cost(np, args, kwargs):
    """(bytes, operations) one deblock_frame call needs: each int32
    plane read once and its result written once, each distinct map and
    the LUTs read once (the frame kernel moves just that: its tiles'
    halos are re-read from L2, the neighbour levels come from the level
    maps). The executor's chroma planes share their edge maps, and each
    takes one level map for both directions: a map is counted once by
    its storage (address, elements, element width). The operations are
    deblock_cost's of each plane with its neighbour levels."""
    from dav1d_mirror_tpu_torch.ops.loopfilter import neighbour_levels
    names = ("planes", "edge_v", "edge_h", "lvl_v", "lvl_h", "e_lut",
             "i_lut", "bitdepth")
    a = dict(zip(names, args), **kwargs)
    n_bytes = sum(t.numel() * t.element_size() for t in (a["e_lut"],
                                                         a["i_lut"]))
    n_ops = 0
    maps = {}
    for i, plane in enumerate(a["planes"]):
        ev, eh, lv, lh = (a[k][i] for k in ("edge_v", "edge_h", "lvl_v",
                                            "lvl_h"))
        n_bytes += 2 * 4 * plane.numel()
        for m in (ev, eh, lv, lh):
            maps[(m.data_ptr(), m.numel(), m.element_size())] = \
                m.numel() * m.element_size()
        lvp, lhp = neighbour_levels(lv, lh)
        n_ops += deblock_cost(np, (plane, ev, eh, lv, lvp, lh, lhp,
                                   a["e_lut"], a["i_lut"], i == 0,
                                   a["bitdepth"]), {})[1]
    return n_bytes + sum(maps.values()), n_ops


def cdef_cost(np, args, kwargs):
    """(bytes, operations) one cdef_frame call needs: each plane read and
    written once (int32), the maps and strength tables read; every pixel
    of a block the frame filters (active, with a strength) CDEF_PIXEL_OPS,
    every 8x8 luma block's direction search CDEF_DIR_OPS."""
    planes, idx, ns, ys, uvs = args[:5]
    ssh, ssv, mono = [kwargs[k] for k in ("ss_hor", "ss_ver",
                                          "monochrome")] \
        if len(args) == 5 else args[7:10]
    n = 1 if mono else 3
    n_bytes = sum(2 * 4 * p.numel() for p in planes[:n]) + sum(
        t.numel() * t.element_size() for t in (idx, ns, ys, uvs))
    # the blocks the frame filters, from its maps (cdef_frame's masks)
    bh4, bw4 = ns.shape
    h8, w8 = (bh4 + 1) // 2, (bw4 + 1) // 2
    idx8 = np.repeat(np.repeat(idx.cpu().numpy(), 8, 0), 8, 1)[:h8, :w8]
    nsp = np.pad(ns.cpu().numpy(), ((0, bh4 % 2), (0, bw4 % 2)))
    ns8 = nsp.reshape(h8, 2, w8, 2).any(axis=(1, 3))
    sel = np.maximum(idx8, 0)
    ly, luv = ys.cpu().numpy()[sel], uvs.cpu().numpy()[sel]
    valid = (idx8 >= 0) & ns8
    px = int((valid & (ly > 0)).sum()) * 64
    if not mono:
        px += 2 * int((valid & (luv > 0)).sum()) * (64 >> (ssh + ssv))
    return n_bytes, px * CDEF_PIXEL_OPS + h8 * w8 * CDEF_DIR_OPS


def filter_timed(torch, np, name, calls, scratch, label):
    """A frame's calls of one filter wrapper (deblock_frame: its dbkrun
    record; cdef_frame: its cdef record; or a synthetic frame) timed as
    one unit with the kernel, warm and cold, against the byte and
    operation bound, and with the plain version (device and wall)."""
    from dav1d_mirror_tpu_torch.ops import cdef_cuda, deblock_cuda
    mod = deblock_cuda if FILTER_FNS[name] == "deblock" else cdef_cuda
    fn_k, fn_p = getattr(mod, name), filter_plain()[name]

    def run_k():
        for a, k in calls:
            fn_k(*a, **k)

    def run_p():
        for a, k in calls:
            fn_p(*a, **k)
    warm = time_warm(torch, run_k, 50)
    cold = time_cold(torch, run_k, scratch, 20)
    plain, plain_wall = time_plain(torch, run_p, 3)
    cost = deblock_frame_cost if name == "deblock_frame" else cdef_cost
    n_bytes = n_ops = 0
    for a, k in calls:
        b, o = cost(np, a, k)
        n_bytes += b
        n_ops += o
    b_ms, b_by = bound(n_bytes, n_ops)
    shape = (f"{label}'s {len(calls)} {name} calls "
             f"({', '.join(_describe(name, a, k) for a, k in calls)})")
    print(f"  {FILTER_FNS[name]} {shape}: {warm:.5f} ms warm, {cold:.5f} "
          f"ms cold, plain {plain:.5f} ms device, {plain_wall:.5f} ms "
          f"wall, bound {b_ms:.5f} ms ({b_by}: {n_bytes} bytes, {n_ops} "
          f"ops), {100 * b_ms / warm:.1f}% of bound warm, "
          f"{100 * b_ms / cold:.1f}% cold")
    return dict(ms=warm, cold_ms=cold, plain_ms=plain,
                plain_wall_ms=plain_wall, bound_ms=b_ms, bound_by=b_by,
                shape=shape)


def pass_launches_timed(torch, calls, scratch, label, frame_ms):
    """The deblock_frame calls `calls` as the pass kernel computes them:
    deblock_plane of each plane with its neighbour levels, a launch a
    pass (pass_args), torch.equal with the frame kernel; timed warm and
    cold in the same run as the frame kernel (frame_ms, warm)."""
    from dav1d_mirror_tpu_torch.ops import deblock_cuda, loopfilter
    jobs, want = [], []
    for a, k in calls:
        d = dict(zip(("planes", "edge_v", "edge_h", "lvl_v", "lvl_h",
                      "e_lut", "i_lut", "bitdepth"), a), **k)
        want += deblock_cuda.deblock_frame(*a, **k)
        for i, plane in enumerate(d["planes"]):
            lvp, lhp = loopfilter.neighbour_levels(d["lvl_v"][i],
                                                   d["lvl_h"][i])
            jobs.append((plane, d["edge_v"][i], d["edge_h"][i],
                         d["lvl_v"][i], lvp, d["lvl_h"][i], lhp,
                         d["e_lut"], d["i_lut"], i == 0, d["bitdepth"]))
    got = [deblock_cuda.deblock_plane(*j) for j in jobs]
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want)), \
        f"{label}: deblock_plane differs from deblock_frame"

    def run():
        for j in jobs:
            deblock_cuda.deblock_plane(*j)
    warm = time_warm(torch, run, 50)
    cold = time_cold(torch, run, scratch, 20)
    print(f"  deblock {label} as {2 * len(jobs)} pass launches "
          f"(deblock_plane a plane, torch.equal with deblock_frame): "
          f"{warm:.5f} ms warm, {cold:.5f} ms cold; the frame kernel "
          f"{warm / frame_ms:.2f}x faster warm")
    return dict(pass_ms=warm, pass_cold_ms=cold,
                pass_launches=2 * len(jobs))


def filter_phase(torch, np, owned, kept, scratch, floor_ms):
    """The deblock and CDEF kernels against their plain versions on the
    card (torch.equal): every synthetic case of tools/filter_cases and
    each path's own largest call of each wrapper (`owned` {path:
    ShapeLog or FilterLog}). Then times config 2 frame 3's deblock (its
    deblock_frame call, one launch) beside the same frame as the pass
    kernel's six launches, and its CDEF (its cdef_frame call, one
    launch), the two kernel rows; config 4's 4K frame's deblock the same
    way (`kept` {path: (label, FilterLog kept calls)}; config 4 codes no
    CDEF); and the 4K CDEF frame of tools/filter_cases (every block
    active). Returns the two kernel rows."""
    from dav1d_mirror_tpu_torch.tools import filter_cases
    dev = torch.device("cuda")
    rows = {name: dict(name=name, route="cuda", cases=[], max_abs_err=0,
                       launches=None, library_ms=None, floor_ms=floor_ms)
            for name in ("deblock", "cdef")}
    rows["deblock"].update(
        source="dav1d_mirror_tpu_torch/csrc/deblock.cu",
        replaces="dav1d_mirror_tpu/ops/loopfilter_tpu.py:236 "
                 "(deblock_plane_tpu, with _apply_pass :136 and "
                 "_apply_pass_h :270; XLA on the TPU, not a Pallas "
                 "kernel)")
    rows["cdef"].update(
        source="dav1d_mirror_tpu_torch/csrc/cdef.cu",
        replaces="dav1d_mirror_tpu/ops/cdef_tpu.py:243 (cdef_frame_tpu, "
                 "with cdef_dir_tpu :104 and cdef_filter_plane_tpu :146; "
                 "XLA on the TPU, not a Pallas kernel)")
    t0 = time.perf_counter()
    res = filter_cases.check_all(torch, dev)
    torch.cuda.synchronize()
    bad = [label for label, ok in res if not ok]
    assert not bad, f"filter kernels differ from their plain versions: {bad}"
    for label, _ in res:
        rows["cdef" if label.startswith("cdef") else "deblock"][
            "cases"].append(label)
    print(f"  deblock and CDEF synthetic cases: {len(res)}, all "
          f"torch.equal ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    n_own = 0
    for path, log in owned.items():
        calls = log.filters if isinstance(log, ShapeLog) else log.calls
        for key, (args, kwargs) in sorted(calls.items()):
            name = key.split()[0]
            label = (f"{path} own largest {key}: "
                     f"{_describe(name, args, kwargs)}")
            row = rows[FILTER_FNS[name]]
            row["max_abs_err"] = max(row["max_abs_err"], filter_compare(
                torch, name, args, kwargs))
            row["cases"].append(label)
            n_own += 1
    print(f"  deblock and CDEF own calls: {n_own} on {len(owned)} paths, "
          f"all torch.equal ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    for path, (label, calls) in kept.items():
        for name in ("deblock_frame", "cdef_frame"):
            group = [c for n, c in calls if n == name]
            assert group or (path, name) == ("config 4", "cdef_frame"), (
                path, name, "no call kept")
            if not group:
                print(f"  {label}: no cdef record, no CDEF timing")
                continue
            got = filter_timed(torch, np, name, group, scratch, label)
            if name == "deblock_frame":
                got.update(pass_launches_timed(torch, group, scratch, label,
                                               got["ms"]))
            if path == "config 2":
                rows[FILTER_FNS[name]].update(got)
            else:
                rows[FILTER_FNS[name]]["config4"] = got
    label, kw = filter_cases.cdef_4k_case(np.random.default_rng(2026))
    kw = filter_cases.to_torch(kw, dev)
    a = (tuple(kw.pop("planes")),) + tuple(kw.pop(k) for k in (
        "cdef_idx_map", "noskip4", "y_strengths", "uv_strengths"))
    rows["cdef"]["max_abs_err"] = max(rows["cdef"]["max_abs_err"],
                                      filter_compare(torch, "cdef_frame",
                                                     a, kw))
    rows["cdef"]["4K"] = filter_timed(torch, np, "cdef_frame", [(a, kw)],
                                      scratch, label)
    print(f"  deblock and CDEF timings: {time.perf_counter() - t0:.1f} s")
    return [rows["deblock"], rows["cdef"]]


def filter_launches(shapes, launches, name):
    """The deblock kernel ran once for each dbkrun record of the programs
    (ShapeLog: a frame that deblocks), the CDEF kernel once for each cdef
    record, and the path deblocked. Prints both."""
    ops = {}
    for fr in shapes.frame_ops:
        for k, v in fr.items():
            ops[k] = ops.get(k, 0) + v
    want = {"deblock": ops.get("dbkrun", 0), "cdef": ops.get("cdef", 0)}
    got = {k: launches[k] for k in want}
    assert got == want and got["deblock"] > 0, (
        name, "filter launches", got, "for records", want)
    print(f"{name}: deblock and CDEF launches {got}, for "
          f"{ops.get('dbkrun', 0)} dbkrun ({ops.get('dbk', 0)} dbk) and "
          f"{ops.get('cdef', 0)} cdef records")


def tools_plain():
    """{wrapper: its plain version} of TOOLS_FNS."""
    from dav1d_mirror_tpu_torch.ops import mc
    return {n: getattr(mc, n) for n in TOOLS_FNS}


def _tools_dst(name, args):
    """The tensors a tool wrapper's call writes: its destinations (a
    warp run's planes and arena, a comp or OBMC run's planes)."""
    if name == "warp_run":
        return tuple(args[4]) + ((args[6],) if args[6] is not None else ())
    return tuple(args[3])


def tools_compare(torch, name, args, kwargs):
    """A tool wrapper and its plain version on copies of one call's
    arguments (their destinations are written in place): torch.equal
    required on every tensor the call writes. Returns the max abs
    difference (0)."""
    from dav1d_mirror_tpu_torch.ops import tools_cuda
    a_k, a_p = _clone(args), _clone(args)
    getattr(tools_cuda, name)(*a_k, **_clone(kwargs))
    tools_plain()[name](*a_p, **_clone(kwargs))
    torch.cuda.synchronize()
    got, want = _tools_dst(name, a_k), _tools_dst(name, a_p)
    assert all(torch.equal(g, w) for g, w in zip(got, want)), \
        f"{name} differs from its plain version"
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               if g.numel() else 0 for g, w in zip(got, want))


def _tools_describe(name, args):
    """A tool wrapper call's work, for a case label."""
    if name == "warp_run":
        return (f"{args[1][1]} units of {args[1][0]} entries into "
                f"{[tuple(p.shape) for p in args[4]]}")
    if name == "comp_run":
        return (f"{args[1][2]} work items of {args[1][1]} slots of "
                f"{args[1][0]} entries into "
                f"{[tuple(p.shape) for p in args[3]]}")
    return (f"{args[1][1]} pixels of {args[1][0]} lap entries into "
            f"{[tuple(p.shape) for p in args[3]]}")


def _inside(np, ys, xs, uh, uw, shape):
    """Pixels of (uh, uw) units at (ys, xs) inside a plane of `shape`."""
    H, W = shape
    yy = ys[:, None] + np.arange(uh)[None, :]
    xx = xs[:, None] + np.arange(uw)[None, :]
    return int(sum(((y >= 0) & (y < H)).sum() * ((x >= 0) & (x < W)).sum()
                   for y, x in zip(yy, xx)))


def tools_cost(np, name, args):
    """(bytes, operations) one tool wrapper call needs, from its data:
    each input read once (a warp run: its table, the distinct reference
    pixels its units' clamped windows cover in each plane's stack, their
    rows and destinations; a comp run: its table, the distinct arena
    values its real slots' sides and its seg chroma rows' luma sides
    cover, the distinct wedge mask values, the origins; an OBMC run: its
    table, the blended pixels inside the planes of its laps, read from
    the lap and the plane, their origins, the mask values), each output
    written once (the pixels inside the planes or the slots);
    WARP_UNIT_OPS a warp unit, COMP_PIXEL_OPS a joined and
    OBMC_PIXEL_OPS a blended pixel. A run counts its real rows, slots
    and laps only: the pad rows are not work of its list."""
    from dav1d_mirror_tpu_torch.ops import mc
    if name == "warp_run":
        tab, work, desc, desc16, planes, refs = args[:6]
        d32, d16 = desc.cpu().numpy(), desc16.cpu().numpy()
        n_bytes, out_px, units = 4 * tab.numel(), 0, 0
        seen = [np.zeros(tuple(r.shape), bool) for r in refs]
        k = np.arange(15)
        for e in mc.table_rows(tab, work[0], mc.WENTRY):
            n, fl, pl = e[mc.W_NREAL], e[mc.W_FLAGS], e[mc.W_PLANE]
            rows = d32[e[mc.W_ROWS]:e[mc.W_ROWS] + 10 * n].reshape(
                n, 10).astype(np.int64)
            w = 2 if fl & mc.WF_YS16 else 4
            ys = (d16 if w == 2 else d32)[e[mc.W_YS]:e[mc.W_YS] + n]
            if fl & mc.WF_SLOT:
                out_px += 64 * n
                n_bytes += w * n
            else:
                xs = (d16 if fl & mc.WF_XS16 else d32)[
                    e[mc.W_XS]:e[mc.W_XS] + n]
                out_px += _inside(np, ys.astype(np.int64),
                                  xs.astype(np.int64), 8, 8,
                                  tuple(planes[pl].shape))
                n_bytes += 2 * w * n
            R, H, W = seen[pl].shape
            yy = np.clip(rows[:, 1, None] + k, 0, H - 1)
            xx = np.clip(rows[:, 2, None] + k, 0, W - 1)
            seen[pl][np.clip(rows[:, 0], 0, R - 1)[:, None, None],
                     yy[:, :, None], xx[:, None, :]] = True
            n_bytes += 40 * n
            units += n
        n_bytes += 4 * sum(int(v.sum()) for v in seen) + 4 * out_px
        return n_bytes, WARP_UNIT_OPS * units
    if name == "comp_run":
        tab, work, desc, planes, arena = args[:5]
        ents, rows = mc.comp_table_parts(tab, work)
        d32 = desc.cpu().numpy()
        read = np.zeros(arena.numel(), bool)
        masks = np.zeros(desc.numel(), bool)
        n_bytes, px, joined = 4 * tab.numel(), 0, 0
        for e in ents.tolist():
            n, f, bh, bw = e[mc.C_NREAL], e[mc.C_FIRST], e[mc.C_BH], \
                e[mc.C_BW]
            area = bh * bw
            for side in (e[mc.C_S0], e[mc.C_S1]):
                read[side:side + n * area] = True
            for r in rows[f:f + n].tolist():
                if r[mc.R_KIND] == mc.CJ_WEDGE:
                    masks[r[mc.R_MOFF]:r[mc.R_MOFF] + area] = True
                elif r[mc.R_KIND] == mc.CJ_SEGC:
                    for side in (r[mc.R_L0], r[mc.R_L1]):
                        read[side:side + r[mc.R_LH] * r[mc.R_LW]] = True
            px += _inside(np, d32[e[mc.C_DY]:e[mc.C_DY] + n].astype(np.int64),
                          d32[e[mc.C_DX]:e[mc.C_DX] + n].astype(np.int64),
                          bh, bw, tuple(planes[e[mc.C_PLANE]].shape))
            n_bytes += 8 * n
            joined += n * area
        n_bytes += 4 * (int(read.sum()) + int(masks.sum()) + px)
        return n_bytes, COMP_PIXEL_OPS * joined
    tab, work, desc, planes = args[:4]
    d32 = desc.cpu().numpy()
    n_bytes, px = 4 * tab.numel() + 4 * len(mc.OBMC_MASKS), 0
    for e in mc.table_rows(tab, work[0], mc.OENTRY):
        n = e[mc.O_NREAL]
        y = d32[e[mc.O_YS]:e[mc.O_YS] + n].astype(np.int64)
        x = d32[e[mc.O_XS]:e[mc.O_XS] + n].astype(np.int64)
        p = _inside(np, y, x, e[mc.O_ROWS], e[mc.O_COLS],
                    tuple(planes[e[mc.O_PLANE]].shape))
        px += p
        n_bytes += 4 * (3 * p + 2 * n)
    return n_bytes, OBMC_PIXEL_OPS * px


def tools_singles(calls):
    """The calls with each run split into one-entry lists of its entries,
    in order (tools/tools_cases.one_entry_lists): a launch an entry, as
    the records ran before the work lists."""
    from dav1d_mirror_tpu_torch.tools.tools_cases import one_entry_lists
    out = []
    for n, (a, k) in calls:
        for tab, work in one_entry_lists(a[0], a[1], TOOLS_FNS[n]):
            out.append((n, ((tab, work) + tuple(a[2:]), k)))
    return out


def tools_timed(torch, np, row, calls, scratch, label):
    """A frame's calls of one tool kernel (`row`: warp, comp or obmc;
    calls [(wrapper, (args, kwargs))], in the frame's order) timed as one
    unit with the kernels, warm and cold, against the byte and operation
    bound, and with the plain versions (device and wall). A run is also
    timed warm as one-entry launches (tools_singles), in turns with the
    run: run, one-entry, one-entry, run."""
    from dav1d_mirror_tpu_torch.ops import tools_cuda
    plain = tools_plain()

    def runner(cs, fns):
        def run():
            for n, (a, k) in cs:
                fns(n)(*a, **k)
        return run
    run_k = runner(calls, lambda n: getattr(tools_cuda, n))
    run_p = runner(calls, lambda n: plain[n])
    # at most QUEUE_LAUNCHES launches queued a timing
    reps = max(1, QUEUE_LAUNCHES // len(calls))
    singles = tools_singles(calls)
    one = {}
    if len(singles) != len(calls):
        run_1 = runner(singles, lambda n: getattr(tools_cuda, n))
        reps_1 = max(1, QUEUE_LAUNCHES // len(singles))
        warm_runs = [time_warm(torch, run_k, reps)]
        one = dict(one_entry_ms=[time_warm(torch, run_1, reps_1)
                                 for _ in range(2)],
                   one_entry_launches=len(singles))
        warm_runs.append(time_warm(torch, run_k, reps))
        warm = sum(warm_runs) / 2
    else:
        warm = time_warm(torch, run_k, reps)
    cold = time_cold(torch, run_k, scratch, min(20, max(3, reps)))
    p_ms, p_wall = time_plain(torch, run_p, 1)
    n_bytes = n_ops = 0
    for n, (a, _) in calls:
        b, o = tools_cost(np, n, a)
        n_bytes += b
        n_ops += o
    b_ms, b_by = bound(n_bytes, n_ops)
    names = sorted({n for n, _ in calls})
    shape = (f"{label}'s {len(calls)} {row} launches "
             f"({', '.join(names)})")
    extra = ""
    if one:
        extra = (f" (runs {warm_runs[0]:.5f}, {warm_runs[1]:.5f}); the same "
                 f"entries as {one['one_entry_launches']} one-entry "
                 f"launches in turns: " + ", ".join(
                     f"{v:.5f}" for v in one["one_entry_ms"]) + " ms warm")
    print(f"  {row} {shape}: {warm:.5f} ms warm ({warm / len(calls):.5f} "
          f"a launch){extra}, {cold:.5f} ms cold, plain {p_ms:.5f} ms "
          f"device, {p_wall:.5f} ms wall, bound {b_ms:.5f} ms ({b_by}: "
          f"{n_bytes} bytes, {n_ops} ops), {100 * b_ms / warm:.1f}% of "
          f"bound warm, {100 * b_ms / cold:.1f}% cold")
    return dict(ms=warm, cold_ms=cold, plain_ms=p_ms, plain_wall_ms=p_wall,
                bound_ms=b_ms, bound_by=b_by, shape=shape,
                launch_ms=warm / len(calls), **one)


def tools_phase(torch, np, owned, kept, scratch, floor_ms):
    """The inter tool kernels against their plain versions on the card
    (torch.equal): every synthetic case of tools/tools_cases and each
    path's own largest call of each wrapper (`owned` {path: ShapeLog or
    ToolsLog}). Then times the frame's calls of each kernel (`kept`:
    (label, ToolsLog kept calls) of the tools path's frame
    TOOLS_OPS_FRAME). Returns the three kernel rows."""
    from dav1d_mirror_tpu_torch.tools import tools_cases
    dev = torch.device("cuda")
    rows = {name: dict(name=name, route="cuda", cases=[], max_abs_err=0,
                       launches=None, library_ms=None, floor_ms=floor_ms)
            for name in ("warp", "comp", "obmc")}
    rows["warp"].update(
        source="dav1d_mirror_tpu_torch/csrc/warp.cu",
        replaces="dav1d_mirror_tpu/ops/mc_tpu.py:366 (warp8x8_batch, with "
                 "scatter_units :266 or scatter_slot_units :316 after it; "
                 "XLA-fused on the TPU, not a Pallas kernel)")
    rows["comp"].update(
        source="dav1d_mirror_tpu_torch/csrc/comp.cu",
        replaces="dav1d_mirror_tpu/ops/mc_tpu.py:328/:335/:347 "
                 "(comp_join_wavg, comp_join_wmask, comp_join_mask, with "
                 "scatter_units :266 after them; XLA-fused on the TPU, not "
                 "Pallas kernels)")
    rows["obmc"].update(
        source="dav1d_mirror_tpu_torch/csrc/obmc.cu",
        replaces="dav1d_mirror_tpu/ops/mc_tpu.py:445 (obmc_blend_batch; "
                 "XLA-fused on the TPU, not a Pallas kernel)")
    t0 = time.perf_counter()
    res = tools_cases.check_all(torch, dev)
    torch.cuda.synchronize()
    bad = [label for label, ok in res if not ok]
    assert not bad, f"tool kernels differ from their plain versions: {bad}"
    for label, _ in res:
        rows[label.split()[0]]["cases"].append(label)
    print(f"  inter tool synthetic cases: {len(res)}, all torch.equal "
          f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    n_own = 0
    for path, log in owned.items():
        calls = log.tools if isinstance(log, ShapeLog) else log.calls
        for name, (args, kwargs) in sorted(calls.items()):
            row = rows[TOOLS_FNS[name]]
            row["max_abs_err"] = max(row["max_abs_err"], tools_compare(
                torch, name, args, kwargs))
            row["cases"].append(f"{path} own largest {name}: "
                                f"{_tools_describe(name, args)}")
            n_own += 1
    print(f"  inter tool own calls: {n_own} on {len(owned)} paths, all "
          f"torch.equal ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    label, calls = kept
    for name in ("warp", "comp", "obmc"):
        group = [(n, c) for n, c in calls if TOOLS_FNS[n] == name]
        assert group, (label, name, "no call kept")
        rows[name].update(tools_timed(torch, np, name, group, scratch,
                                      label))
    print(f"  inter tool timings: {time.perf_counter() - t0:.1f} s")
    return [rows["warp"], rows["comp"], rows["obmc"]]


def tools_launches(shapes, launches, name):
    """The warp kernel ran once for each warprun record of the programs
    (ShapeLog; at most one a frame: its warp records and "w" sub-ops),
    the comp kernel once for each comprun record (at most one a frame:
    its comp records), the OBMC kernel once for each obmcrun record (at
    most two a frame: one an OBMC phase). Prints the launches and the
    records."""
    ops = {}
    for fr in shapes.frame_ops:
        assert fr.get("warprun", 0) <= 1 and fr.get("comprun", 0) <= 1 \
            and fr.get("obmcrun", 0) <= 2, (name, "tool runs a frame", fr)
        assert bool(fr.get("comp")) == bool(fr.get("comprun")), \
            (name, "comp records without their comprun", fr)
        for k, v in fr.items():
            ops[k] = ops.get(k, 0) + v
    want = {"warp": ops.get("warprun", 0), "comp": ops.get("comprun", 0),
            "obmc": ops.get("obmcrun", 0)}
    got = {k: launches[k] for k in want}
    assert got == want, (name, "tool launches", got, "for records", want)
    print(f"{name}: inter tool launches {got}, for {want['warp']} warprun "
          f"records ({ops.get('warp', 0)} warp records and "
          f"{ops.get('comp w', 0)} \"w\" sub-ops), {want['comp']} "
          f"comprun records ({ops.get('comp', 0)} comp records) and "
          f"{want['obmc']} obmcrun records ({ops.get('obmc', 0)} obmc "
          f"records)")


# coefficients at the int16/int32 extremes: the butterflies' products wrap
ITX_EXTREMES = (-(1 << 31), (1 << 31) - 1, -32768, 32767, -(1 << 19),
                (1 << 19) - 1)


def itx_case(np, torch, frame_exec, itx, rng, tx, bd, kind, dev):
    """A synthetic bucket of tx size `tx` on the card: 60 units and 4 pad
    rows (PAD_OOB origins) on an 8 x 8 grid of unit cells that the plane
    cuts at its right and bottom edges. kind "sparse": every block has at
    most 16 nonzeros (the planner's sparse buckets, K = 16); "mixed":
    sparse blocks, blocks with every coefficient set (K = sh * sw) and one
    at the int16/int32 extremes; "wht": sparse lossless 4x4 blocks.
    Selectors cover every allowed type. Returns (vals, pos, sel, ys, xs,
    plane shape)."""
    from dav1d_mirror_tpu_torch.ops.itx_meta import (TX_INFO, WHT_WHT,
                                                     allowed_txtypes)
    from dav1d_mirror_tpu_torch.ops.mc import PAD_OOB
    w, h, _ = TX_INFO[tx]
    sh, sw = min(h, 32), min(w, 32)
    S = sh * sw
    B, n_real = 64, 60
    amp = 900 << (bd - 8)
    cf = np.zeros((B, S), np.int64)
    for i in range(n_real):
        if kind == "mixed" and i % 6 == 0:
            v = rng.integers(-amp, amp, S)
            v[v == 0] = 1
            cf[i] = v
        else:
            nz = int(rng.integers(1, min(16, S) + 1))
            cf[i, rng.choice(S, nz, replace=False)] = \
                rng.integers(1, amp, nz) * rng.choice([-1, 1], nz)
    if kind == "mixed":
        k = min(S, 8)
        cf[n_real - 1, rng.choice(S, k, replace=False)] = \
            rng.choice(ITX_EXTREMES, k)
    vals, pos, K = frame_exec.compact_cf(
        cf.astype(np.int32).reshape(B, sh, sw))
    Kp = 1 << (K - 1).bit_length()       # pad lanes, as the planner
    vals = np.pad(vals, ((0, 0), (0, Kp - K)))
    pos = np.pad(pos, ((0, 0), (0, Kp - K)), constant_values=S)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
    if kind == "wht":
        sel = WHT_WHT
    else:
        types = [tp for tp in allowed_txtypes(tx) if tp != WHT_WHT]
        ss = np.array([itx.itx_multi_sel(tx, types[j])
                       for j in rng.integers(0, len(types), B)], np.int32)
        sel = (t(ss[:, 0]), t(ss[:, 1]))
    cells = rng.permutation(64)[:B]
    ys = cells // 8 * h
    xs = cells % 8 * w
    ys[n_real:] = PAD_OOB
    shape = (7 * h + (h + 1) // 2, 7 * w + (w + 1) // 2)
    return t(vals), t(pos), sel, t(ys), t(xs), shape


def itx_compare(torch, np, itx, itx_cuda, rng, call, label):
    """The kernel against its plain version on one bucket (torch.equal):
    call = (mode, vals, pos, sel, tx, bd, plane (shape, dtype) or None,
    ys, xs, out_dtype); the plane is random pixels. Returns the max abs
    difference (0)."""
    mode, vals, pos, sel, tx, bd, plane, ys, xs, out_dtype = call
    args = (mode, vals, pos, sel, tx, bd)
    if mode == "hres":
        # None: the caller took the wrappers' default
        kw = {} if out_dtype is None else {"out_dtype": out_dtype}
        got = itx_cuda.itx_bucket(*args, **kw)
        want = itx.itx_bucket(*args, **kw)
    else:
        (H, W), dt = plane
        px = torch.from_numpy(rng.integers(0, 1 << bd, (H, W)).astype(
            np.int32)).to(vals.device).to(dt)
        got = itx_cuda.itx_bucket(*args, px.clone(), ys, xs)
        want = itx.itx_bucket(*args, px.clone(), ys, xs)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want), \
        f"itx differs from its plain version: {label}"
    return int((got.long() - want.long()).abs().max())


def itx_run_case(np, frame_exec, itx, rng, mode, bd):
    """A synthetic work list of one run as a planner emits it: for every
    tx size a sparse bucket (at most 16 nonzeros a block) of 12 real
    blocks and 4 pad rows, a WHT 4x4 bucket, and dense tails (one block
    with every coefficient set, K = sh * sw) at 4x4, 16x16, 32x32, 64x64
    and 16x64; in each bucket a block at the int16 (int16 buffer) or
    int32 extremes; vals in the int16 buffer where they fit (bd 8, every
    other bucket), pos in the int16 or int32 one by turns; selectors over
    every allowed type; three planes, each bucket's units in a band of two
    unit rows of six, the last of each row cut by the right edge, the last
    band of each plane by the bottom edge. Returns (sig, desc, desc16,
    plane shapes)."""
    from dav1d_mirror_tpu_torch.ops.itx_meta import (TX_INFO, WHT_WHT,
                                                     allowed_txtypes)
    from dav1d_mirror_tpu_torch.ops.mc import PAD_OOB
    specs = [(tx, "sparse") for tx in range(19)] + [(0, "wht")] + \
        [(tx, "dense") for tx in (0, 2, 3, 4, 17)]
    W_PL, per_row = 352, 6
    band, placed = [0, 0, 0], []
    for i, (tx, _) in enumerate(specs):
        placed.append((i % 3, band[i % 3]))
        band[i % 3] += 2 * TX_INFO[tx][1]
    last = {pl: max(i for i, (p, _) in enumerate(placed) if p == pl)
            for pl in range(3)}
    shapes = [(band[pl] - TX_INFO[specs[last[pl]][0]][1] // 2, W_PL)
              for pl in range(3)]
    prog = frame_exec.FrameProgram(3, bd, shapes)
    amp = 900 << (bd - 8)
    with frame_exec.ItxRun(prog, mode) as run:
        for i, ((tx, kind), (pl, y0)) in enumerate(zip(specs, placed)):
            w, h, _ = TX_INFO[tx]
            sh, sw = min(h, 32), min(w, 32)
            S = sh * sw
            n_real, B = 12, 16
            narrow = bd == 8 and i % 2 == 0
            cf = np.zeros((B, S), np.int64)
            for b in range(n_real):
                nz = int(rng.integers(1, min(16, S) + 1))
                cf[b, rng.choice(S, nz, replace=False)] = \
                    rng.integers(1, amp, nz) * rng.choice([-1, 1], nz)
            if kind == "dense":
                v = rng.integers(-amp, amp, S)
                v[v == 0] = 1
                cf[3] = v
            ext = (-32768, 32767) if narrow else ITX_EXTREMES
            k = min(S, 8)
            cf[n_real - 1, :] = 0
            cf[n_real - 1, rng.choice(S, k, replace=False)] = \
                rng.choice(ext, k)
            vals, pos, K = frame_exec.compact_cf(
                cf.astype(np.int32).reshape(B, sh, sw))
            Kp = 1 << (K - 1).bit_length()
            vals = np.pad(vals, ((0, 0), (0, Kp - K)))
            pos = np.pad(pos, ((0, 0), (0, Kp - K)), constant_values=S)
            h_v = prog.emit16(vals) if narrow else prog.emit(vals)
            h_p = prog.emit16(pos) if i % 3 != 1 else prog.emit(pos)
            j = np.arange(B)
            ys = (y0 + j // per_row * h).astype(np.int32)
            xs = np.where(j % per_row == per_row - 1, W_PL - w // 2,
                          j % per_row * w).astype(np.int32)
            ys[n_real:] = PAD_OOB
            types = [t for t in allowed_txtypes(tx) if t != WHT_WHT]
            sel = np.array([itx.itx_multi_sel(
                tx, types[int(rng.integers(len(types)))]) for _ in range(B)],
                np.int32)
            wht = kind == "wht"
            if mode == "hres":
                rec = ("hresc", tx, WHT_WHT, sh, sw, h_v, h_p) if wht else \
                    ("hresmc", tx, sh, sw, h_v, h_p, prog.emit(sel[:, 0]),
                     prog.emit(sel[:, 1]))
            else:
                h_ys, h_xs = prog.emit(ys), prog.emit(xs)
                if wht and mode == "add":
                    rec = ("residc", pl, sh, sw, tx, WHT_WHT, h_v, h_p, h_ys,
                           h_xs)
                elif wht:
                    rec = ("resrawc", pl, tx, WHT_WHT, sh, sw, h_v, h_p,
                           h_ys, h_xs)
                else:
                    rec = ("residmc" if mode == "add" else "resrawmc", pl,
                           sh, sw, tx, h_v, h_p, prog.emit(sel[:, 0]),
                           prog.emit(sel[:, 1]), h_ys, h_xs)
            run.op(*rec, n_real=n_real)
    sig, desc, desc16, _ = prog.finalize()
    return sig, desc, desc16, shapes


def frame_runs(sig, desc):
    """[(mode, table view of desc, work, hres views)] of a program's
    itxrun records."""
    out = []
    for rec in sig[0]:
        if rec[0] == "itxrun":
            _, mode, (off, shape), work, views = rec
            out.append((mode, desc[off:off + shape[0]], work, views))
    return out


def itx_run_compare(torch, np, itx, itx_cuda, rng, call, label):
    """The kernel against its plain version on one work list
    (torch.equal): call = dict(mode, tab, work, desc, desc16, bd, planes
    [(shape, dtype)], hres_views, hres_dtype); the planes are random
    pixels. Returns the max abs difference (0)."""
    args = (call["mode"], call["tab"], call["work"], call["desc"],
            call["desc16"], call["bd"])
    planes = [torch.from_numpy(rng.integers(0, 1 << call["bd"], sh).astype(
        np.int32)).to(call["desc"].device).to(dt) for sh, dt in
        call["planes"]]
    kw = {"hres_views": call["hres_views"]}
    if call["hres_dtype"] is not None:
        kw["hres_dtype"] = call["hres_dtype"]
    got_p = [p.clone() for p in planes]
    want_p = [p.clone() for p in planes]
    got = itx_cuda.itx_run(*args, got_p, **kw)
    want = itx.itx_run(*args, want_p, **kw)
    torch.cuda.synchronize()
    got, want = (got or []) + got_p, (want or []) + want_p
    assert len(got) == len(want) and all(
        g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want)), \
        f"itx differs from its plain version: {label}"
    return max([int((g.long() - w.long()).abs().max()) for g, w in
                zip(got, want) if g.numel()] + [0])


def itx_entry_cost(np, itx, gen_itx_cuh, mode, e, d32, d16, plane, hres_b,
                   vals=None, pos=None, rsel=None, csel=None, ys=None,
                   xs=None):
    """(bytes, operations) one table entry needs: its real blocks'
    coefficients, positions, selectors and origins read once, the pixels
    of its units inside the plane read (add) and written once (hres: its
    residuals written, pad rows included); the operations of the
    generated code for the data: each block's nonzero rows through the
    zero-tail variant of its last nonzero column, its columns through
    the variant of its last nonzero row, the roundings, the prescale and
    the clip-add. Blocks outside the plane count nothing. e: the entry's
    ENTRY ints; d32/d16: the int32 and int16 buffers (numpy) its offsets
    count from, or the one-entry call's arrays in vals..xs; plane:
    ((H, W), bytes a pixel); hres_b: bytes an hres element."""
    from dav1d_mirror_tpu_torch.ops.itx_meta import TX_INFO
    tx, fl = e[itx.E_TX], e[itx.E_FLAGS]
    K, B, n = e[itx.E_K], e[itx.E_B], e[itx.E_NREAL]
    w, h, _ = TX_INFO[tx]
    sh, sw = min(h, 32), min(w, 32)
    S = sh * sw

    def sl(f, narrow, cnt):
        src = d16 if narrow else d32
        return src[e[f]:e[f] + cnt].astype(np.int64)
    v16, p16 = bool(fl & itx.F_VALS16), bool(fl & itx.F_POS16)
    if vals is None:
        vals = sl(itx.E_VALS, v16, B * K).reshape(B, K)
        if not fl & itx.F_DENSE:
            pos = sl(itx.E_POS, p16, B * K).reshape(B, K)
    vals = vals[:n]
    pos = np.broadcast_to(np.arange(K), (n, K)) if fl & itx.F_DENSE else \
        pos[:n]
    wht, fixed = bool(fl & itx.F_WHT), bool(fl & itx.F_FIXED)
    if fixed:
        rs, cs = np.full(n, e[itx.E_RSEL]), np.full(n, e[itx.E_CSEL])
    elif rsel is not None:
        rs, cs = rsel[:n], csel[:n]
    else:
        rs, cs = sl(itx.E_RSEL, False, n), sl(itx.E_CSEL, False, n)
    n_bytes = n * K * ((2 if v16 else 4) + (0 if fl & itx.F_DENSE else
                                            2 if p16 else 4))
    n_bytes += 0 if fixed else 8 * n
    if mode == "hres":
        live = np.ones(n, bool)
        n_bytes += B * h * w * hres_b
        n_px = 0
    else:
        (H, W), px_b = plane
        if ys is None:
            ys, xs = sl(itx.E_YS, False, n), sl(itx.E_XS, False, n)
        yy = ys[:n, None, None] + np.arange(h)[None, :, None]
        xx = xs[:n, None, None] + np.arange(w)[None, None, :]
        inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        live = inside.any(axis=(1, 2))
        n_px = int(inside.sum())
        n_bytes += 8 * n + n_px * px_b * (2 if mode == "add" else 1)
    dense = np.zeros((n, S + 1), np.int64)
    np.put_along_axis(dense, np.clip(pos, 0, S).astype(np.int64), vals,
                      axis=1)
    nzb = (dense[:, :S] != 0).reshape(n, sh, sw)
    rows = nzb.any(axis=2)
    cols = nzb.any(axis=1)
    last_r = np.where(rows.any(axis=1), sh - 1 - np.argmax(rows[:, ::-1],
                                                             axis=1), -1)
    last_c = np.where(cols.any(axis=1), sw - 1 - np.argmax(cols[:, ::-1],
                                                             axis=1), -1)
    rect2 = w == 2 * h or h == 2 * w
    fam_w = ("wht",) if wht else itx.itx_families(w)
    fam_h = ("wht",) if wht else itx.itx_families(h)
    n_ops = 0
    for b in np.nonzero(live)[0]:
        nz_rows = int(rows[b].sum())
        nnz = int(nzb[b].sum())
        if wht:
            n_ops += nz_rows * 8 + w * 8 + nnz
        else:
            fr = fam_w[rs[b]] if 0 <= rs[b] < len(fam_w) else fam_w[0]
            fc = fam_h[cs[b]] if 0 <= cs[b] < len(fam_h) else fam_h[0]
            m_r = gen_itx_cuh.tail_inputs(int(last_c[b]) + 1, w)
            m_c = gen_itx_cuh.tail_inputs(int(last_r[b]) + 1, h)
            n_ops += nz_rows * gen_itx_cuh.op_count(
                fr, w, None if m_r == sw else m_r)
            n_ops += w * gen_itx_cuh.op_count(fc, h,
                                               None if m_c == sh else m_c)
            n_ops += nnz * (3 if rect2 else 0) + 3 * nz_rows * w + 2 * h * w
    if mode == "add":
        n_ops += 2 * n_px
    return n_bytes, n_ops


def itx_run_bound(np, itx, gen_itx_cuh, call):
    """(least ms, what bounds it) of one work list: the sum of its entries'
    itx_entry_cost, and its table read once."""
    mode, work = call["mode"], call["work"]
    tab = call["tab"].cpu().numpy()
    d32 = call["desc"].cpu().numpy()
    d16 = call["desc16"].cpu().numpy()
    hres_b = 4 if call["hres_dtype"] is None else call["hres_dtype"].itemsize
    n_bytes = tab.size * 4
    n_ops = 0
    for e in itx.table_entries(tab, work[0]):
        plane = None
        if mode != "hres":
            shp, dt = call["planes"][e[itx.E_PLANE]]
            plane = (shp, dt.itemsize)
        b, o = itx_entry_cost(np, itx, gen_itx_cuh, mode, e, d32, d16,
                              plane, hres_b)
        n_bytes += b
        n_ops += o
    return bound(n_bytes, n_ops)


def time_plain(torch, fn, n):
    """(device ms, wall ms) per call of a plain version: the summed time
    of the kernels that n calls ran, by torch.profiler (which also reads
    a version that syncs with the host itself, as the plain itx
    version's masked scatter does, where no launch can be queued ahead
    of the card) in the second of two profiled steps
    (tools/filter_ops.device_ms: the first warms the tracer up, whose
    first kernels can go unrecorded), over n, and time_wall's host wall
    time."""
    from dav1d_mirror_tpu_torch.tools.filter_ops import device_ms
    fn()
    torch.cuda.synchronize()
    dev_ms = device_ms(fn, n)[0]
    assert dev_ms > 0, "the profiler saw no kernel of the plain version"
    return dev_ms, time_wall(torch, fn, n)


def time_wall(torch, fn, n):
    """Wall ms per call of n synchronized calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def itx_phase(torch, np, itx, itx_cuda, frame_exec, owned, scratch,
              floor_ms):
    """The itx kernel against its plain version on the card
    (torch.equal): synthetic work lists (itx_run_case) in the three
    modes at bd 8/10/12 on int32 and narrow planes; one-entry buckets of
    every tx size at bd 8/10/12 in the three modes (int32 and narrow
    planes) on sparse and mixed coefficients, and WHT (itx_case); each
    path's own largest work list of each mode and own largest one-entry
    bucket of every (mode, tx size, one type, dense) in `owned` ({path:
    ShapeLog or ItxLog}). Then, on config 2's frame 3 program (its
    ShapeLog's kept_program): the clip-add run's warm and cold time,
    bound, plain device and wall time, the same buckets as one-entry
    launches in turns with the run (one-entry, run, run, one-entry), and
    the run's largest 32x32 bucket as a one-entry list. Returns the
    kernel row of the JSON line."""
    from dav1d_mirror_tpu_torch.ops.itx_meta import TX_INFO, WHT_WHT
    from dav1d_mirror_tpu_torch.tools import gen_itx_cuh
    dev = torch.device("cuda")
    rng = np.random.default_rng(2025)
    cases, max_err = [], 0
    t0 = time.perf_counter()
    for bd in (8, 10, 12):
        narrow = torch.uint8 if bd == 8 else torch.int16
        hres_t = torch.int16 if bd == 8 else torch.int32
        for mode in itx.MODES:
            sig, desc, desc16, shapes = itx_run_case(np, frame_exec, itx,
                                                     rng, mode, bd)
            desc = torch.from_numpy(desc).to(dev)
            desc16 = torch.from_numpy(desc16).to(dev)
            (_, tab, work, views), = frame_runs(sig, desc)
            for dt in ((None,) if mode == "hres" else (torch.int32,
                                                       narrow)):
                label = (f"work list {mode} bd{bd} {work[0]} entries "
                         f"({work[1]} work items)"
                         + ("" if dt is None else f" {dt}"))
                max_err = max(max_err, itx_run_compare(
                    torch, np, itx, itx_cuda, rng, dict(
                        mode=mode, tab=tab, work=work, desc=desc,
                        desc16=desc16, bd=bd,
                        planes=[] if dt is None else
                        [(sh, dt) for sh in shapes],
                        hres_views=views, hres_dtype=hres_t), label))
                cases.append(label)
    for tx in sorted(TX_INFO):
        for bd in (8, 10, 12):
            narrow = torch.uint8 if bd == 8 else torch.int16
            hres_t = torch.int16 if bd == 8 else torch.int32
            kinds = ("sparse", "mixed") + (("wht",) if tx == 0 else ())
            for kind in kinds:
                vals, pos, sel, ys, xs, shape = itx_case(
                    np, torch, frame_exec, itx, rng, tx, bd, kind, dev)
                calls = [("hres", None, hres_t),
                         ("add", torch.int32, None),
                         ("raw", torch.int32, None)]
                if kind != "sparse":
                    calls += [("add", narrow, None), ("raw", narrow, None)]
                for mode, dt, odt in calls:
                    label = (f"one-entry tx {tx} {TX_INFO[tx][0]}x"
                             f"{TX_INFO[tx][1]} bd{bd} {kind} "
                             f"K={vals.shape[1]} {mode}"
                             + ("" if dt is None else f" {dt}"))
                    max_err = max(max_err, itx_compare(
                        torch, np, itx, itx_cuda, rng,
                        (mode, vals, pos, sel, tx, bd,
                         None if dt is None else (shape, dt), ys, xs, odt),
                        label))
                    cases.append(label)
    n_synth = len(cases)
    for path, shapes in owned.items():
        for mode, c in sorted(shapes.runs.items()):
            label = (f"{path} own largest work list {mode}: {c['work'][0]} "
                     f"entries, {c['work'][1]} work items, bd{c['bd']}")
            max_err = max(max_err, itx_run_compare(torch, np, itx, itx_cuda,
                                                   rng, c, label))
            cases.append(label)
        for (mode, tx, const, dense), c in sorted(shapes.itx.items()):
            call = (c["mode"], c["vals"], c["pos"], c["sel"], c["tx"],
                    c["bd"], c["plane"], c["ys"], c["xs"], c["out_dtype"])
            label = (f"{path} own largest one-entry {mode} tx {tx} "
                     f"{TX_INFO[tx][0]}x{TX_INFO[tx][1]} "
                     f"B={c['vals'].shape[0]} K={c['vals'].shape[1]} "
                     f"bd{c['bd']}" + (" one type" if const else "")
                     + (" dense" if dense else ""))
            max_err = max(max_err, itx_compare(torch, np, itx, itx_cuda,
                                               rng, call, label))
            cases.append(label)
    print(f"  itx: equal to plain in {n_synth} synthetic and "
          f"{len(cases) - n_synth} decode cases "
          f"({time.perf_counter() - t0:.1f} s)")

    # ---- config 2's frame 3: its clip-add run ----
    sig, desc, desc16 = owned["config 2"].kept_program[:3]
    bd, shapes = sig[2], sig[3]
    (_, tab, work, _), = [r for r in frame_runs(sig, desc) if r[0] == "add"]
    planes = [torch.from_numpy(rng.integers(0, 1 << bd, sh).astype(
        np.int32)).to(dev) for sh in shapes]
    call = dict(mode="add", tab=tab, work=work, desc=desc, desc16=desc16,
                bd=bd, planes=[(p.shape, p.dtype) for p in planes],
                hres_views=(), hres_dtype=None)
    entries = itx.table_entries(tab, work[0])

    def run_k():
        return itx_cuda.itx_run("add", tab, work, desc, desc16, bd, planes)

    def run_p():
        return itx.itx_run("add", tab, work, desc, desc16, bd, planes)
    # the same buckets as one-entry launches (every row, as the old
    # executor gave them; coefficients widened to int32 before the clock)
    per = []
    for e in entries:
        B, K = e[itx.E_B], e[itx.E_K]

        def sl(f, narrow, n):
            src = desc16 if narrow else desc
            return src[e[f]:e[f] + n].to(torch.int32)
        fl = e[itx.E_FLAGS]
        vals = sl(itx.E_VALS, fl & itx.F_VALS16, B * K).view(B, K)
        pos = sl(itx.E_POS, fl & itx.F_POS16, B * K).view(B, K)
        sel = WHT_WHT if fl & itx.F_WHT else (
            desc[e[itx.E_RSEL]:e[itx.E_RSEL] + B],
            desc[e[itx.E_CSEL]:e[itx.E_CSEL] + B])
        per.append((vals, pos, sel, e[itx.E_TX], bd, planes[e[itx.E_PLANE]],
                    desc[e[itx.E_YS]:e[itx.E_YS] + B],
                    desc[e[itx.E_XS]:e[itx.E_XS] + B]))

    def run_b():
        for args in per:
            itx_cuda.itx_bucket("add", *args)
    # a few hundred launches a timing: more would fill the launch queue,
    # and the host could then not queue ahead of the card
    reps_b = max(1, 400 // len(per))
    turns = [time_warm(torch, run_b, reps_b), time_warm(torch, run_k, 100),
             time_warm(torch, run_k, 100), time_warm(torch, run_b, reps_b)]
    warm = min(turns[1:3])
    cold = time_cold(torch, run_k, scratch, 20)
    plain, plain_wall = time_plain(torch, run_p, 3)
    b_ms, b_by = itx_run_bound(np, itx, gen_itx_cuh, call)
    n_blocks = sum(e[itx.E_NREAL] for e in entries)
    shape = (f"config 2 frame {OPS_FRAME}'s clip-add run: {work[0]} "
             f"entries, {n_blocks} real blocks, {work[1]} work items, "
             f"bd{bd}, int32 planes {shapes[0]}")
    print(f"  itx {shape}: {warm:.5f} ms warm, {cold:.5f} ms cold, "
          f"plain {plain:.5f} ms device, {plain_wall:.5f} ms wall, "
          f"bound {b_ms:.5f} ms ({b_by}), {100 * b_ms / warm:.1f}% of "
          f"bound warm")
    print(f"  itx the same {work[0]} buckets as one-entry launches, in turns "
          f"(one-entry, run, run, one-entry): " +
          ", ".join(f"{t:.5f}" for t in turns) +
          f" ms; one-entry / run {min(turns[0], turns[3]) / warm:.1f}x")
    # config 2's largest 32x32 clip-add bucket of the decode as a one-entry
    # list (the bucket the one-launch-a-bucket design was timed at)
    best = None
    for c in owned["config 2"].add_runs:
        for e in itx.table_entries(c["tab"], c["work"][0]):
            if e[itx.E_TX] == 3 and (best is None or
                                     e[itx.E_B] > best[1][itx.E_B]):
                best = (c, e)
    one = None
    if best is not None:
        c, e = best
        B, K = e[itx.E_B], e[itx.E_K]
        d32, d16 = c["desc"], c["desc16"]
        fl = e[itx.E_FLAGS]
        src_v = d16 if fl & itx.F_VALS16 else d32
        src_p = d16 if fl & itx.F_POS16 else d32
        (H, W), _ = c["planes"][e[itx.E_PLANE]]
        plane = torch.from_numpy(rng.integers(0, 1 << bd, (H, W)).astype(
            np.int32)).to(dev)
        args = (src_v[e[itx.E_VALS]:e[itx.E_VALS] + B * K].to(
                    torch.int32).view(B, K),
                src_p[e[itx.E_POS]:e[itx.E_POS] + B * K].to(
                    torch.int32).view(B, K),
                (d32[e[itx.E_RSEL]:e[itx.E_RSEL] + B],
                 d32[e[itx.E_CSEL]:e[itx.E_CSEL] + B]), 3, bd, plane,
                d32[e[itx.E_YS]:e[itx.E_YS] + B],
                d32[e[itx.E_XS]:e[itx.E_XS] + B])

        def run_one(args=args):
            return itx_cuda.itx_bucket("add", *args)
        o_warm = time_warm(torch, run_one, 100)
        o_cold = time_cold(torch, run_one, scratch, 20)
        o_b, o_o = itx_entry_cost(np, itx, gen_itx_cuh, "add", e,
                                  d32.cpu().numpy(), d16.cpu().numpy(),
                                  ((H, W), 4), 4)
        o_ms, o_by = bound(o_b, o_o)
        one = dict(B=B, n_real=e[itx.E_NREAL], K=K, warm=o_warm,
                   cold=o_cold, bound=o_ms, by=o_by)
        print(f"  itx config 2's largest 32x32 clip-add bucket (B={B}, "
              f"{e[itx.E_NREAL]} real, K={K}) as a one-entry list: "
              f"{o_warm:.5f} ms warm, {o_cold:.5f} ms cold, bound "
              f"{o_ms:.5f} ms ({o_by})")
    return dict(
        name="itx", route="cuda",
        source="dav1d_mirror_tpu_torch/csrc/itx.cu",
        replaces="dav1d_mirror_tpu/ops/itx.py:116 (_residual_multi_core "
                 "with the expand and clip-add around it; XLA-fused on "
                 "the TPU, not a Pallas kernel)",
        launches=None, max_abs_err=max_err, ms=warm, plain_ms=plain,
        plain_wall_ms=plain_wall, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, cold_ms=cold, floor_ms=floor_ms, cases=cases,
        shape=shape, one_entry_ms=turns, bucket32=one)


def ops_phase(torch, frame_exec, wrapped, program, swaps, label,
              forbid=(), kernels=False):
    """A frame's program (a ShapeLog's `kept_program`) replayed on the
    card with the kernels and with the plain versions of `swaps`
    ((module, name, plain function)) in their place (the other kernels
    stay): its wall ms in turns kernel, plain, plain, kernel, then the
    eager ops each issues by family (tools/filter_ops.family_ops over
    `wrapped`); the planes and residuals of both equal. The functions of
    `forbid` ((module, name)) must not run in the kernel route. With
    `kernels`, also the device ms of the kernels one replay of each route
    runs (tools/filter_ops.device_ms: summed, and by kernel name).
    Returns {route: ({family: ops}, [ms, ms][, (ms, {kernel: ms})])}."""
    from dav1d_mirror_tpu_torch.tools.filter_ops import device_ms, \
        family_ops
    sig, *args = program
    orig = [getattr(mod, n) for mod, n, _ in swaps]
    calls = {n: 0 for _, n in forbid}
    out = {}
    results = {}

    def use(route):
        for (mod, n, plain), fn in zip(swaps, orig):
            setattr(mod, n, fn if route == "kernel" else plain)

    def spy(mod, n):
        fn = getattr(mod, n)

        def inner(*a, **k):
            calls[n] += 1
            return fn(*a, **k)
        return fn, inner

    def run():
        return frame_exec.execute_program(sig, *args)
    try:
        for route in ("kernel", "plain", "plain", "kernel"):
            use(route)
            spies = [(mod, n) + spy(mod, n) for mod, n in forbid] \
                if route == "kernel" else []
            for mod, n, _, inner in spies:
                setattr(mod, n, inner)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                res = run()
                torch.cuda.synchronize()
            finally:
                for mod, n, fn, _ in spies:
                    setattr(mod, n, fn)
            ms = (time.perf_counter() - t0) * 1e3
            results.setdefault(route, res)
            out.setdefault(route, [None, []])[1].append(ms)
        for route in ("kernel", "plain"):
            use(route)
            out[route][0] = family_ops(frame_exec, wrapped, run)
            if kernels:
                out[route].append(device_ms(run))
    finally:
        use("kernel")
    assert not any(calls.values()), (label, "kernel route called", calls)
    (pk, hk), (pp, hp) = results["kernel"], results["plain"]
    assert len(pk) == len(pp) and len(hk) == len(hp)
    assert all(torch.equal(a, b) for a, b in zip(pk + hk, pp + hp)), \
        f"{label}: kernel and plain routes differ"
    return {k: tuple(v) for k, v in out.items()}


def print_ops(what, label, ops):
    """Print an ops_phase result."""
    (k_fam, k_ms, *_), (p_fam, p_ms, *_) = ops["kernel"], ops["plain"]
    print(f"{what} ops: {label}'s program replayed on the card: "
          f"{sum(k_fam.values())} eager ops with the kernels, "
          f"{sum(p_fam.values())} with the plain version in their place; "
          f"wall ms " + ", ".join(f"{t:.1f}" for t in k_ms) +
          " with the kernels, " + ", ".join(f"{t:.1f}" for t in p_ms) +
          " plain (turns kernel, plain, plain, kernel); equal planes and "
          "residuals")
    for route, (fams, _, *dev) in ops.items():
        print(f"{what} ops by family, {label}, {route} route: " + ", ".join(
            f"{k} {v}" for k, v in sorted(fams.items(),
                                          key=lambda kv: -kv[1])))
        if dev:
            total, by = dev[0]
            print(f"{what} device ms, {label}, {route} route: {total:.5f} "
                  f"ms of kernels a replay; the largest: " + ", ".join(
                      f"{k[:60]} {v:.5f}" for k, v in list(by.items())[:8]))


def report_path(name, frames, times, shapes, launches, digests, split,
                staged_s):
    """Print one path's frame times, op kinds per frame and stage split."""
    ms = [t * 1e3 for t in times]
    steady = times[2:]
    print(f"{name}: {len(frames)} frames, md5 {digests}, launches "
          f"{launches}")
    print(f"{name} frame ms: " + ", ".join(f"{t:.1f}" for t in ms))
    if any(w0 != w1 for w0, w1 in shapes.widths):
        print(f"{name} coded/output widths: " + ", ".join(
            f"{w0}/{w1}" for w0, w1 in shapes.widths))
    for i, ops in enumerate(shapes.frame_ops):
        print(f"{name} frame {i} ops: " + ", ".join(
            f"{k} {v}" for k, v in sorted(ops.items())))
    print(f"{name} unit MC slot arena bytes a frame: " + ", ".join(
        str(b) for b in shapes.arena))
    print(f"{name}: frame 0 (keyframe, cold) {ms[0]:.1f} ms; frame 1 "
          f"(first inter) {ms[1]:.1f} ms; steady fps over frames "
          f"2-{len(frames) - 1}: {len(steady) / sum(steady):.3f}")
    print(f"{name} stage split (staged pass, %.1f ms total): " %
          (staged_s * 1e3) +
          ", ".join(f"{k} {v * 1e3:.1f} ms ({100 * v / staged_s:.1f}%)"
                    for k, v in sorted(split.items(),
                                       key=lambda kv: -kv[1])))


def moved(launches, name, scaled=False):
    """Every kernel counter moved in a path's run; the scaled MC kernel's
    only on a path with scaled references (`scaled`); the deblock, CDEF
    and inter tool kernels' as its records ask (filter_launches,
    tools_launches)."""
    idle = [k for k, v in launches.items()
            if v <= 0 and (scaled or k != "mc_scaled") and
            k not in ("deblock", "cdef", *set(TOOLS_FNS.values()))]
    assert not idle, (name, idle, launches)


def one_launch_per_run(shapes, launches, name):
    """The itx kernel ran once for each run of the programs' work lists
    (ShapeLog), and never as a one-entry list; each unit MC kernel once
    for each program with its work (an mcurun record: puts, comp t,
    obmc t; an mcsrun record: scaled, comp s, obmc s), never as a
    one-entry list. Prints the unit MC launches and records."""
    assert launches["itx"] == shapes.itx_expected and not shapes.itx, (
        name, launches, shapes.itx_expected, sorted(shapes.itx))
    ops = {}
    for fr in shapes.frame_ops:
        for k, v in fr.items():
            ops[k] = ops.get(k, 0) + v
    want = {MCU_ROW[k]: ops.get(k, 0) for k in MCU_RUNS}
    got = {k: launches[k] for k in want}
    assert got == want and not shapes.mcu, (
        name, "unit MC launches", got, "runs", want, sorted(shapes.mcu))
    recs = {k: sum(ops.get(r, 0) for r in rs) for k, rs in (
        ("mc_units", ("put", "comp t", "obmc t")),
        ("mc_scaled", ("scaled", "comp s", "obmc s")))}
    print(f"{name}: unit MC launches {got}, one a program with its work, "
          f"for {recs} records and sub-ops")


def staged(stages, run):
    """Run `run` with the stage split on (each stage synchronizes the
    device on exit). Returns (run's result, {stage: seconds})."""
    stages.reset()
    stages.enabled = True
    try:
        out = run()
    finally:
        stages.enabled = False
    return out, stages.seconds()


def profile_frames(torch, api, MD5Muxer, frames, out_dir):
    """torch.profiler table over two steady inter frames. Returns the
    device ms per frame of each MC kernel and of all kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    dec = api.Decoder(api.Settings(device="cuda"))
    mux = MD5Muxer()
    for fr in frames[:3]:
        dec.send_data(fr.data)
        while (pic := dec.get_picture()) is not None:
            mux.write(pic)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fr in frames[3:5]:
            dec.send_data(fr.data)
            while (pic := dec.get_picture()) is not None:
                mux.write(pic)
        torch.cuda.synchronize()
    ka = prof.key_averages()

    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
    per_frame = {n: sum(e.self_device_time_total for e in kernels
                        if k in e.key) / 2e3
                 for n, k in (("mc_hplanes", "mc_hplanes_kernel"),
                              ("mc_vpass", "mc_vpass_kernel"),
                              ("mc_units", "mc_units_run_kernel"),
                              ("mc_scaled", "mc_scaled_run_kernel"),
                              ("itx", "itx_run_kernel"),
                              ("deblock", "deblock_"),
                              ("cdef", "cdef_"))}
    per_frame["all kernels"] = sum(e.self_device_time_total
                                   for e in kernels) / 2e3
    for key in ("cuda_time_total", "cpu_time_total"):
        path = os.path.join(out_dir, f"profile_by_{key}.txt")
        with open(path, "w") as f:
            f.write(ka.table(sort_by=key, row_limit=60))
    print(f"profile: tables written to {out_dir}")
    print(ka.table(sort_by="cuda_time_total", row_limit=15))
    return per_frame


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also write torch.profiler tables to DIR")
    opts = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)

    # ---- 1. card and build ----
    t_start = time.perf_counter()

    def mark(what):
        """Print the command's seconds so far, before the next phase."""
        print(f"time: {time.perf_counter() - t_start:.1f} s, before {what}")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    build_all()

    import numpy as np
    from dav1d_mirror_tpu_torch import api
    from dav1d_mirror_tpu_torch.host.demux import open_demuxer
    from dav1d_mirror_tpu_torch.host.ivf import parse_ivf
    from dav1d_mirror_tpu_torch.models import frame_exec, intra
    from dav1d_mirror_tpu_torch.ops import cdef, cdef_cuda, deblock_cuda, \
        itx, itx_cuda, loopfilter, mc, mc_cuda, mcu_cuda, tools_cuda
    from dav1d_mirror_tpu_torch.output import MD5Muxer
    from dav1d_mirror_tpu_torch.utils import stages

    def counted(run):
        """run() with every launch counter set to 0 just before it;
        returns (run's result, {kernel: launches during it})."""
        mc_cuda.HPLANES_LAUNCHES = 0
        mc_cuda.VPASS_LAUNCHES = 0
        mcu_cuda.UNITS_LAUNCHES = 0
        mcu_cuda.SCALED_LAUNCHES = 0
        itx_cuda.ITX_LAUNCHES = 0
        itx_cuda.ITX_ENTRIES = 0
        deblock_cuda.DEBLOCK_LAUNCHES = 0
        cdef_cuda.CDEF_LAUNCHES = 0
        tools_cuda.WARP_LAUNCHES = 0
        tools_cuda.COMP_LAUNCHES = 0
        tools_cuda.OBMC_LAUNCHES = 0
        out = run()
        return out, {"mc_hplanes": mc_cuda.HPLANES_LAUNCHES,
                     "mc_vpass": mc_cuda.VPASS_LAUNCHES,
                     "mc_units": mcu_cuda.UNITS_LAUNCHES,
                     "mc_scaled": mcu_cuda.SCALED_LAUNCHES,
                     "itx": itx_cuda.ITX_LAUNCHES,
                     "itx entries": itx_cuda.ITX_ENTRIES,
                     "deblock": deblock_cuda.DEBLOCK_LAUNCHES,
                     "cdef": cdef_cuda.CDEF_LAUNCHES,
                     "warp": tools_cuda.WARP_LAUNCHES,
                     "comp": tools_cuda.COMP_LAUNCHES,
                     "obmc": tools_cuda.OBMC_LAUNCHES}

    mark('config 2 path')
    # ---- config 2 path (run first: the kernel phase uses its shapes) ----
    with open(STREAM, "rb") as f:
        _, _, _, frames = parse_ivf(f.read())
    with ShapeLog(mc_cuda, frame_exec, api) as shapes:
        shapes.keep_frame = shapes.keep_filter_frame = OPS_FRAME
        (digest, n_pics, times), launches = counted(lambda: decode(
            api, MD5Muxer, frames, torch, shapes.on_frame))
    assert n_pics == len(frames) == 9, (n_pics, len(frames))
    assert digest == STREAM_MD5, f"md5 {digest} != {STREAM_MD5}"
    moved(launches, "config 2")
    one_launch_per_run(shapes, launches, "config 2")
    filter_launches(shapes, launches, "config 2")
    tools_launches(shapes, launches, "config 2")
    (digest2, _, times2), split = staged(
        stages, lambda: decode(api, MD5Muxer, frames, torch))
    assert digest2 == STREAM_MD5, f"md5 {digest2} (staged pass)"

    mark('the engine path')
    # ---- the engine path: config 2 with the device intra engine, twice
    # (the second pass staged), then a third pass counting the eager ops
    # of each frame's wave scan ----
    with ShapeLog(mc_cuda, frame_exec, api, intra) as shapes_e:
        (d_e, n_e, times_e), launches_e = counted(lambda: decode(
            api, MD5Muxer, frames, torch, shapes_e.on_frame,
            intra_engine=True))
    assert n_e == 9 and d_e == STREAM_MD5, f"engine md5 {d_e} ({n_e})"
    # the same MC work as the hybrid route: as many launches of each MC
    # kernel (the residual buckets differ: the engine's are per plane and
    # tx size, the hybrid's split sparse and dense)
    moved(launches_e, "config 2 engine")
    assert all(launches_e[k] == launches[k]
               for k in ("mc_hplanes", "mc_vpass", "mc_units", "deblock",
                         "cdef")), (launches_e, launches)
    routes_e = check_engine_routes(shapes_e, "config 2 engine")
    # the keyframe on the engine's own route, and every inter frame
    # eligible (plain intra blocks only) and full-device
    assert routes_e == {"intra": 1, "mixed": 8, "hybrid": 0}, routes_e
    one_launch_per_run(shapes_e, launches_e, "config 2 engine")
    filter_launches(shapes_e, launches_e, "config 2 engine")
    tools_launches(shapes_e, launches_e, "config 2 engine")
    (d_es, _, times_es), split_e = staged(stages, lambda: decode(
        api, MD5Muxer, frames, torch, intra_engine=True))
    assert d_es == STREAM_MD5, f"engine md5 {d_es} (staged pass)"
    assert "host-pass2" not in split_e, split_e
    with ShapeLog(mc_cuda, frame_exec, api, intra) as shapes_c:
        shapes_c.count_ops = op_counter(torch)
        d_c, _, _ = decode(api, MD5Muxer, frames, torch, shapes_c.on_frame,
                           intra_engine=True)
    assert d_c == STREAM_MD5, f"engine md5 {d_c} (op-counting pass)"
    assert shapes_c.scans == shapes_e.scans, "the scans differ by pass"

    mark('config 3 path')
    # ---- config 3 path: with grain, without grain, staged ----
    with open(STREAM3, "rb") as f:
        _, _, _, frames3 = parse_ivf(f.read())
    with ShapeLog(mc_cuda, frame_exec, api) as shapes3:
        shapes3.keep_filter_frame = C3_FILTER_FRAME
        (d3, n3, times3), launches3 = counted(lambda: decode(
            api, MD5Muxer, frames3, torch, shapes3.on_frame))
    d3_plain, n3_plain, _ = decode(api, MD5Muxer, frames3, torch,
                                   apply_grain=False)
    assert n3 == n3_plain == len(frames3) == 5, (n3, n3_plain)
    assert (d3, d3_plain) == (CONFIG3_MD5[True], CONFIG3_MD5[False]), (
        f"config 3 md5 with grain {d3}, without {d3_plain}; expected "
        f"{CONFIG3_MD5}")
    moved(launches3, "config 3")
    one_launch_per_run(shapes3, launches3, "config 3")
    filter_launches(shapes3, launches3, "config 3")
    tools_launches(shapes3, launches3, "config 3")
    assert any("lrw" in ops for ops in shapes3.frame_ops), \
        "config 3 ran no loop restoration op"
    (d3_staged, _, times3s), split3 = staged(
        stages, lambda: decode(api, MD5Muxer, frames3, torch))
    assert d3_staged == CONFIG3_MD5[True], f"md5 {d3_staged} (staged pass)"
    assert split3.get("grain", 0) > 0, split3
    with open(os.path.join(STREAMS, "md5.txt")) as f:
        corpus_md5 = dict(line.split()[::-1] for line in f if line.strip())
    for name in LR_STREAMS:
        with open(os.path.join(STREAMS, name), "rb") as f:
            _, _, _, fr = parse_ivf(f.read())
        with ShapeLog(mc_cuda, frame_exec, api) as lr_shapes:
            d, _, _ = decode(api, MD5Muxer, fr, torch, lr_shapes.on_frame,
                             apply_grain=False)
        kinds = sorted({k for ops in lr_shapes.frame_ops for k in ops
                        if k in ("lrw", "lrs")})
        assert d == corpus_md5[name], f"{name}: md5 {d}"
        print(f"{name}: md5 {d} as in md5.txt, LR ops {kinds}")

    mark('tools path')
    # ---- tools path: compound, warp, OBMC, inter-intra; twice ----
    with open(os.path.join(TOOLS_DIR, TOOLS_STREAM), "rb") as f:
        _, _, _, frames_t = parse_ivf(f.read())
    tools_md5, tools_n = TOOLS_STREAMS[TOOLS_STREAM]
    with ShapeLog(mc_cuda, frame_exec, api) as shapes_t:
        shapes_t.keep_frame = TOOLS_RUN_FRAME
        shapes_t.keep_ops_frame = TOOLS_OPS_FRAME
        (d_t, n_t, times_t), launches_t = counted(lambda: decode(
            api, MD5Muxer, frames_t, torch, shapes_t.on_frame))
    assert n_t == len(frames_t) == tools_n, (n_t, len(frames_t))
    assert d_t == tools_md5, f"tools md5 {d_t} != {tools_md5}"
    moved(launches_t, "tools")
    one_launch_per_run(shapes_t, launches_t, "tools")
    filter_launches(shapes_t, launches_t, "tools")
    tools_launches(shapes_t, launches_t, "tools")
    tools_kinds = {k for ops in shapes_t.frame_ops for k in ops}
    assert {"comp", "warp", "obmc"} <= tools_kinds, tools_kinds
    assert shapes_t.ii_blocks > 0, "the tools path ran no inter-intra block"
    # the staged pass: the same hash again (CUDA applies duplicate writes
    # in any order; the planner keeps duplicates equal or sacrificial)
    (d_ts, _, times_ts), split_t = staged(
        stages, lambda: decode(api, MD5Muxer, frames_t, torch))
    assert d_ts == tools_md5, f"tools md5 {d_ts} (staged pass)"
    for name in TOOLS_CORPUS + ("lossless_128x64.ivf",):
        lossless = name.startswith("lossless")
        path = os.path.join(TOOLS_DIR if lossless else STREAMS, name)
        with open(path, "rb") as f:
            _, _, _, fr = parse_ivf(f.read())
        with ShapeLog(mc_cuda, frame_exec, api) as s_shapes:
            d, n, _ = decode(api, MD5Muxer, fr, torch, s_shapes.on_frame,
                             apply_grain=False)
        want = TOOLS_STREAMS[name][0] if lossless else corpus_md5[name]
        kinds = sorted({k for ops in s_shapes.frame_ops for k in ops
                        if k in ("comp", "warp", "obmc", "residc",
                                 "hresc")})
        assert d == want, f"{name}: md5 {d} != {want}"
        assert not lossless or "residc" in kinds, kinds
        print(f"{name}: md5 {d} as recorded, {n} frames, ops {kinds}, "
              f"{s_shapes.ii_blocks} inter-intra blocks")

    mark('Decoder.apply_grain')
    # ---- Decoder.apply_grain: config 3 decoded without grain, each
    # picture grained on its own ----
    dec = api.Decoder(api.Settings(device="cuda", apply_grain=False))
    mux = MD5Muxer()
    for fr in frames3:
        dec.send_data(fr.data)
        while (pic := dec.get_picture()) is not None:
            mux.write(dec.apply_grain(pic))
    torch.cuda.synchronize()
    assert (mux.digest(), mux.n) == (CONFIG3_APPLY_GRAIN_MD5, 5), (
        f"config 3 through Decoder.apply_grain: md5 {mux.digest()}")
    print(f"config 3 through Decoder.apply_grain: md5 {mux.digest()} as "
          f"recorded, {mux.n} frames")

    mark('super-res path')
    # ---- super-res path: scaled MC and super-res; twice ----
    with open(os.path.join(TOOLS_DIR, SUPERRES_STREAM), "rb") as f:
        _, _, _, frames_s = parse_ivf(f.read())
    sr_md5, sr_n = TOOLS_STREAMS[SUPERRES_STREAM]
    with ShapeLog(mc_cuda, frame_exec, api) as shapes_s:
        shapes_s.keep_frame = SR_OPS_FRAME
        (d_s, n_s, times_s), launches_s = counted(lambda: decode(
            api, MD5Muxer, frames_s, torch, shapes_s.on_frame))
    assert n_s == len(frames_s) == sr_n, (n_s, len(frames_s))
    assert d_s == sr_md5, f"super-res md5 {d_s} != {sr_md5}"
    moved(launches_s, "superres", scaled=True)
    one_launch_per_run(shapes_s, launches_s, "superres")
    filter_launches(shapes_s, launches_s, "superres")
    tools_launches(shapes_s, launches_s, "superres")
    sr_kinds = {k for ops in shapes_s.frame_ops for k in ops}
    assert {"scaled", "sres", "comp s", "obmc s"} <= sr_kinds, sr_kinds
    assert any(w0 == w1 for w0, w1 in shapes_s.widths) and \
        len({w0 for w0, _ in shapes_s.widths}) == 4, shapes_s.widths
    # the staged pass, with the split of each frame (every inter block of
    # a super-res frame goes through the planner's per-block loop)
    snaps = []
    (d_ss, _, times_ss), split_s = staged(
        stages, lambda: decode(api, MD5Muxer, frames_s, torch,
                               lambda i: snaps.append(stages.seconds())))
    assert d_ss == sr_md5, f"super-res md5 {d_ss} (staged pass)"
    snaps.append(split_s)
    split_s_frames = [{k: b[k] - a.get(k, 0) for k in b}
                      for a, b in zip(snaps, snaps[1:])]
    for name in SUPERRES_CORPUS:
        with open(os.path.join(STREAMS, name), "rb") as f:
            _, _, _, fr = parse_ivf(f.read())
        with ShapeLog(mc_cuda, frame_exec, api) as c_shapes:
            d, n, _ = decode(api, MD5Muxer, fr, torch, c_shapes.on_frame,
                             apply_grain=False)
        kinds = sorted({k for ops in c_shapes.frame_ops for k in ops
                        if k in ("scaled", "sres", "comp s", "obmc s")})
        assert d == corpus_md5[name], f"{name}: md5 {d}"
        assert "sres" in kinds, kinds
        print(f"{name}: md5 {d} as in md5.txt, {n} frames, ops {kinds}, "
              f"coded/output widths {c_shapes.widths}")

    mark('the profile paths')
    # ---- the profile paths: 12-bit 4:2:2 and 10-bit 4:4:4 ----
    profiles = {key: profile_phase(api, MD5Muxer, torch, stages, counted,
                                   mc_cuda, frame_exec, parse_ivf, key,
                                   name, kinds)
                for key, name, kinds in PROFILE_PATHS}

    mark('the intra corpus streams on both routes')
    # ---- the intra corpus streams on both routes ----
    for name in ENGINE_CORPUS:
        with open(os.path.join(STREAMS, name), "rb") as f:
            _, _, _, fr = parse_ivf(f.read())
        for engine in (False, True):
            with ShapeLog(mc_cuda, frame_exec, api, intra) as c_shapes:
                d, n, _ = decode(api, MD5Muxer, fr, torch,
                                 c_shapes.on_frame, apply_grain=False,
                                 intra_engine=engine)
            assert d == corpus_md5[name], f"{name} engine {engine}: md5 {d}"
            rts = check_engine_routes(c_shapes, name)
            if engine:
                assert c_shapes.routes[0] == "intra", c_shapes.routes
            else:
                assert rts["hybrid"] == n, rts
            print(f"{name}: md5 {d} as in md5.txt on the "
                  f"{'engine' if engine else 'hybrid'} route, {n} frames, "
                  f"routes {rts}, scans (waves, units, filter cells) "
                  f"{[x for sc in c_shapes.scans for x in sc]}")

    mark('the small format streams on both routes')
    # ---- the small format streams on both routes ----
    formats_phase(api, MD5Muxer, torch, mc_cuda, frame_exec, intra,
                  parse_ivf, corpus_md5)

    mark('the CLI on the card, with the engine')
    # ---- the CLI on the card, with the engine ----
    t0 = time.perf_counter()
    cli_cmd = [sys.executable, "-m", "dav1d_mirror_tpu_torch.cli", "-i",
               os.path.join("tests", "streams", CLI_STREAM[0]), "--muxer",
               "md5", "--verify", CLI_STREAM[1], "--intraengine"]
    r = subprocess.run(cli_cmd, cwd=HERE, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, (r.returncode, r.stdout, r.stderr[-3000:])
    print(f"cli: {' '.join(cli_cmd[1:])} exit 0 in "
          f"{time.perf_counter() - t0:.1f} s: "
          + " / ".join(r.stderr.strip().splitlines()[-2:]))

    mark('config 4')
    # ---- config 4: 4K 10-bit, 2x2 tiles ----
    with open(STREAM4, "rb") as f:
        _, _, _, frames4 = parse_ivf(f.read())
    with ShapeLog(mc_cuda, frame_exec, api) as shapes4:
        shapes4.keep_filter_frame = C4_FILTER_FRAME
        (d4, n4, times4), launches4 = counted(lambda: decode(
            api, MD5Muxer, frames4, torch, shapes4.on_frame))
    assert n4 == len(frames4) == 3, (n4, len(frames4))
    assert d4 == CONFIG4_MD5, f"config 4 md5 {d4} != {CONFIG4_MD5}"
    moved(launches4, "config 4")
    one_launch_per_run(shapes4, launches4, "config 4")
    filter_launches(shapes4, launches4, "config 4")
    tools_launches(shapes4, launches4, "config 4")
    (d4s, _, times4s), split4 = staged(
        stages, lambda: decode(api, MD5Muxer, frames4, torch))
    assert d4s == CONFIG4_MD5, f"config 4 md5 {d4s} (staged pass)"

    mark('the pipelined paths')
    # ---- the pipelined paths: config 2 and the tools path through the
    # four-stage pipeline, against their serial decodes above ----
    piped, piped_itx, piped_mcu, piped_filters, piped_tools = \
        pipelined_phase(
        api, MD5Muxer, torch, stages, counted,
        {"config 2": (frames, STREAM_MD5), "tools": (frames_t, tools_md5)})
    # the same programs: one unit MC launch a program with its work, and
    # the deblock, CDEF and inter tool launches of their records, as in
    # the serial decodes
    for name, serial in (("config 2", launches), ("tools", launches_t)):
        assert all(piped[name][k] == serial[k] for k in
                   (*MCU_ROW.values(), "deblock", "cdef",
                    *set(TOOLS_FNS.values()))), \
            (name, "pipelined unit MC, filter and tool launches",
             piped[name], serial)
        print(f"pipelined {name}: inter tool launches " + ", ".join(
            f"{k} {piped[name][k]}" for k in ("warp", "comp", "obmc")) +
            ", as in its serial decode")

    mark('the parallel paths at world size 1 on the card')
    # ---- the parallel paths at world size 1 on the card ----
    _, _, sharded_itx, sharded_mcu, sharded_filters, sharded_tools = \
        parallel_phase(torch)

    mark('2. kernel phase')
    # ---- 2. kernel phase ----
    rows = kernel_phase(torch, np, mc, mc_cuda, shapes)
    own_calls_phase(torch, mc, mc_cuda, shapes3, "config 3", rows)
    own_calls_phase(torch, mc, mc_cuda, shapes_t, "tools", rows)
    own_calls_phase(torch, mc, mc_cuda, shapes_s, "superres", rows)
    for key, prof in profiles.items():
        own_calls_phase(torch, mc, mc_cuda, prof["shapes"], key, rows)
    mark("the itx phase")
    rows.append(itx_phase(
        torch, np, itx, itx_cuda, frame_exec,
        {"config 2": shapes, "config 3": shapes3, "tools": shapes_t,
         "config 4": shapes4, "superres": shapes_s, "engine": shapes_e,
         "pipelined config 2": piped_itx["config 2"],
         "pipelined tools": piped_itx["tools"], "sharded": sharded_itx,
         **{key: prof["shapes"] for key, prof in profiles.items()}},
        torch.empty(SCRATCH_BYTES, dtype=torch.uint8, device="cuda"),
        rows[0]["floor_ms"]))
    owned = {"config 2": shapes, "config 3": shapes3, "tools": shapes_t,
             "config 4": shapes4, "superres": shapes_s, "engine": shapes_e,
             "pipelined config 2": piped_mcu["config 2"],
             "pipelined tools": piped_mcu["tools"], "sharded": sharded_mcu,
             **{key: prof["shapes"] for key, prof in profiles.items()}}
    mark("the unit MC phase")
    rows.extend(mcu_phase(
        torch, np, mc, mcu_cuda, owned,
        torch.empty(SCRATCH_BYTES, dtype=torch.uint8, device="cuda"),
        rows[0]["floor_ms"]))
    mark("the filter phase")
    rows.extend(filter_phase(
        torch, np,
        {"config 2": shapes, "config 3": shapes3, "tools": shapes_t,
         "config 4": shapes4, "superres": shapes_s, "engine": shapes_e,
         "pipelined config 2": piped_filters["config 2"],
         "pipelined tools": piped_filters["tools"],
         "sharded": sharded_filters,
         **{key: prof["shapes"] for key, prof in profiles.items()}},
        {"config 2": (f"config 2 frame {OPS_FRAME}", shapes.filter_kept),
         "config 4": (f"config 4 frame {C4_FILTER_FRAME} (4K)",
                      shapes4.filter_kept)},
        torch.empty(SCRATCH_BYTES, dtype=torch.uint8, device="cuda"),
        rows[0]["floor_ms"]))
    mark("the inter tool phase")
    rows.extend(tools_phase(
        torch, np,
        {"config 2": shapes, "tools": shapes_t, "superres": shapes_s,
         "pipelined tools": piped_tools["tools"], "sharded": sharded_tools,
         **{key: prof["shapes"] for key, prof in profiles.items()}},
        (f"tools frame {TOOLS_OPS_FRAME}", shapes_t.tools_kept),
        torch.empty(SCRATCH_BYTES, dtype=torch.uint8, device="cuda"),
        rows[0]["floor_ms"]))
    wrapped = [(mc_cuda, "mc_hplanes"), (mc_cuda, "mc_unit_batch_hv"),
               (itx_cuda, "itx_run"), (itx_cuda, "itx_bucket"),
               (deblock_cuda, "deblock_frame"), (cdef_cuda, "cdef_frame")] + [
        (mcu_cuda, fn) for fn in (*MCU_KINDS.values(), *MCU_RUNS.values())] + [
        (tools_cuda, fn) for fn in TOOLS_FNS]
    c2_label = f"config 2 frame {OPS_FRAME}"
    mark("the ops phases")
    itx_ops = ops_phase(torch, frame_exec, wrapped, shapes.kept_program,
                        [(itx_cuda, "itx_run", itx.itx_run)], c2_label)
    # the unit MC kernels' plain versions in their place; in the kernel
    # route no unit MC work may reach a plain MC function
    mcu_ops = {label: ops_phase(
        torch, frame_exec, wrapped, prog,
        [(mcu_cuda, fn, getattr(mc, fn)) for fn in MCU_RUNS.values()],
        label, [(mc, n) for n in ("mc_unit_batch", "mc_scaled_batch",
                                  *MCU_KINDS.values(),
                                  *MCU_RUNS.values())])
        for label, prog in ((c2_label, shapes.kept_program),
                            (f"super-res frame {SR_OPS_FRAME}",
                             shapes_s.kept_program))}
    # the deblock and CDEF kernels' plain versions in their place; in the
    # kernel route no plain deblock or CDEF function may run
    filter_ops = {label: ops_phase(
        torch, frame_exec, wrapped, prog,
        [(deblock_cuda, "deblock_frame", loopfilter.deblock_frame),
         (cdef_cuda, "cdef_frame", cdef.cdef_frame)], label,
        [(loopfilter, n) for n in ("deblock_frame", "deblock_plane",
                                   "_apply_pass")] +
        [(cdef, n) for n in ("cdef_frame", "cdef_filter_plane",
                             "cdef_dir")], kernels=True)
        for label, prog in ((f"{c2_label} filter", shapes.kept_filter),
                            (f"config 3 frame {C3_FILTER_FRAME} filter",
                             shapes3.kept_filter))}
    # the inter tool kernels' plain versions in their place; in the kernel
    # route no eager tool function may run
    tools_ops = {label: ops_phase(
        torch, frame_exec, wrapped, prog,
        [(tools_cuda, fn, getattr(mc, fn)) for fn in TOOLS_FNS], label,
        [(mc, n) for n in TOOLS_EAGER])
        for label, prog in ((f"tools frame {TOOLS_OPS_FRAME}",
                             shapes_t.kept_ops_program),
                            (f"super-res frame {SR_OPS_FRAME}",
                             shapes_s.kept_program))}
    for r in rows:
        r["launches"] = launches[r["name"]]
        r["launches_config3"] = launches3[r["name"]]
        r["launches_tools"] = launches_t[r["name"]]
        r["launches_config4"] = launches4[r["name"]]
        r["launches_superres"] = launches_s[r["name"]]
        r["launches_engine"] = launches_e[r["name"]]
        r["launches_pipelined_config2"] = piped["config 2"][r["name"]]
        r["launches_pipelined_tools"] = piped["tools"][r["name"]]
        for key, prof in profiles.items():
            r[f"launches_{key}"] = prof["launches"][r["name"]]
        print(f"kernel {r['name']}: equal to plain in "
              f"{len(r['cases'])} cases; at {r['shape']}: "
              f"{r['ms']:.5f} ms warm ({100 * r['bound_ms'] / r['ms']:.1f}% "
              f"of bound), {r['cold_ms']:.5f} ms cold "
              f"({100 * r['bound_ms'] / r['cold_ms']:.1f}% of bound), "
              f"empty-launch floor {r['floor_ms']:.5f} ms, "
              f"plain {r['plain_ms']:.5f} ms device, "
              f"{r['plain_wall_ms']:.5f} ms wall, "
              f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}); "
              f"{r['launches']} launches in the config 2 decode, "
              f"{r['launches_config3']} in the config 3 decode, "
              f"{r['launches_tools']} in the tools decode, "
              f"{r['launches_config4']} in the config 4 decode, "
              f"{r['launches_superres']} in the super-res decode, "
              f"{r['launches_engine']} in the config 2 engine decode, "
              f"{r['launches_pipelined_config2']} in the pipelined config "
              f"2 decode, {r['launches_pipelined_tools']} in the pipelined "
              f"tools decode, {r['launches_pro']} in the Professional "
              f"(12-bit 4:2:2) decode, {r['launches_high']} in the High "
              f"(10-bit 4:4:4) decode")
        for c in r["cases"]:
            if c.startswith(("config 3", "tools", "superres", "pro",
                             "high")) or " own " in c:
                print(f"  {r['name']} equal to plain: {c}")
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_config3", "launches_tools", "launches_config4",
            "launches_superres", "launches_engine",
            "launches_pipelined_config2", "launches_pipelined_tools",
            "launches_pro", "launches_high", "max_abs_err", "ms",
            "plain_ms", "plain_wall_ms", "bound_ms", "bound_by",
            "library_ms", "cold_ms", "floor_ms")
    table = [{k: r[k] for k in keys} for r in rows]
    print("kernels: " + json.dumps(table))
    print_ops("itx", c2_label, itx_ops)
    for label, ops in mcu_ops.items():
        print_ops("unit MC", label, ops)
    for label, ops in filter_ops.items():
        print_ops("filter", label, ops)
    for label, ops in tools_ops.items():
        print_ops("tools", label, ops)

    mark('3. path reports')
    # ---- 3. path reports ----
    report_path("config 2", frames, times, shapes, launches,
                {"expected": STREAM_MD5, "got": digest}, split, sum(times2))
    report_path("config 3", frames3, times3, shapes3, launches3,
                {"grain": d3, "no grain": d3_plain}, split3, sum(times3s))
    report_path("tools", frames_t, times_t, shapes_t, launches_t,
                {"expected": tools_md5, "got": d_t, "staged": d_ts},
                split_t, sum(times_ts))
    print(f"tools: {shapes_t.ii_blocks} inter-intra blocks")
    report_path("config 4", frames4, times4, shapes4, launches4,
                {"expected": CONFIG4_MD5, "got": d4}, split4, sum(times4s))
    report_path("superres", frames_s, times_s, shapes_s, launches_s,
                {"expected": sr_md5, "got": d_s, "staged": d_ss},
                split_s, sum(times_ss))
    for i, (sp, t) in enumerate(zip(split_s_frames, times_ss)):
        print(f"superres frame {i} stage split (staged pass, "
              f"{t * 1e3:.1f} ms): " + ", ".join(
                  f"{k} {v * 1e3:.1f} ms ({100 * v / t:.1f}%)"
                  for k, v in sorted(sp.items(), key=lambda kv: -kv[1])))
    for key, prof in profiles.items():
        report_path(key, prof["frames"], prof["times"], prof["shapes"],
                    prof["launches"], prof["digests"], prof["split"],
                    prof["staged_s"])
        print(f"{key}: {prof['shapes'].ii_blocks} inter-intra blocks; "
              f"steady fps against config 2's in this call: "
              f"{len(prof['times'][2:]) / sum(prof['times'][2:]):.3f} vs "
              f"{len(times[2:]) / sum(times[2:]):.3f}")
    report_path("config 2 engine", frames, times_e, shapes_e, launches_e,
                {"expected": STREAM_MD5, "got": d_e, "staged": d_es},
                split_e, sum(times_es))
    print(f"config 2 engine routes: {routes_e}")
    for i, (t, sc, n_ops) in enumerate(zip(times_e, shapes_c.scans,
                                           shapes_c.scan_ops)):
        waves = sum(w for w, _, _ in sc)
        print(f"config 2 engine frame {i} ({shapes_e.routes[i]}): "
              f"{t * 1e3:.1f} ms, {waves} waves, "
              f"{sum(u for _, u, _ in sc)} units, "
              f"{sum(c for _, _, c in sc)} filter cells, {n_ops} eager ops "
              f"in its scan, {n_ops / max(waves, 1):.1f} per wave")
    steady = times[2:]
    steady_e = times_e[2:]
    print(f"engine vs hybrid, config 2, this call: frame 0 "
          f"{times_e[0] * 1e3:.1f} ms vs {times[0] * 1e3:.1f} ms; frame 1 "
          f"{times_e[1] * 1e3:.1f} ms vs {times[1] * 1e3:.1f} ms; steady fps "
          f"(frames 2-8) {len(steady_e) / sum(steady_e):.3f} vs "
          f"{len(steady) / sum(steady):.3f}")
    if opts.profile:
        per_frame = profile_frames(torch, api, MD5Muxer, frames,
                                   opts.profile)
        frame_ms = 1e3 * sum(steady) / len(steady)
        print(f"profile, device ms per steady frame (frames 3-4): " +
              ", ".join(f"{k} {v:.3f} ({100 * v / frame_ms:.3f}% of the "
                        f"{frame_ms:.1f} ms steady frame)"
                        for k, v in per_frame.items()))

    mark('fuzz')
    # ---- fuzz: corrupt streams decode on the card as on the CPU,
    # and a clean decode still matches after them ----
    n_copies, n_dec, n_err, fuzz_s = fuzz_phase(api, MD5Muxer, torch, np,
                                                open_demuxer)
    with open(os.path.join(STREAMS, "inter_basic.ivf"), "rb") as f:
        _, _, _, fr = parse_ivf(f.read())
    d, _, _ = decode(api, MD5Muxer, fr, torch, apply_grain=False)
    assert d == corpus_md5["inter_basic.ivf"], f"inter_basic after fuzz {d}"
    print(f"fuzz: {n_copies} mutated copies of {', '.join(FUZZ_STREAMS)} "
          f"(seed {FUZZ_SEED}), {n_dec} decodes on both routes, the card's "
          f"outcome equal to the CPU's in every one, {n_err} copies with a "
          f"contained error; {fuzz_s:.1f} s; inter_basic after it: md5 {d} "
          f"as in md5.txt")

    mark('4. result lines')
    # ---- 4. result lines ----
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
