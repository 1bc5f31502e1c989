# Ported from examples/player.py (yuv_to_rgb :34, keyframe_tus :56, main :73).
"""Minimal AV1 stream player on SDL (reference: examples/dav1dplay.c).

    python -m dav1d_mirror_tpu_torch.player clip.ivf [--untimed]
        [--frames N] [--null] [--device cpu]

Decodes an IVF/Annex-B/Section-5 stream with the PyTorch port and presents
it through pygame/SDL, paced to the container frame rate (dav1dplay paces
against the PTS clock, dav1dplay.c:500-540). Controls match the reference
player: space = pause, escape/q = quit, left/right = seek to the
previous/next keyframe (dav1dplay seeks through the demuxer and flushes
the decoder, :410-450).

--null renders to SDL's dummy driver (decode and convert, no window), so
the player runs headless; --untimed turns pacing off. The pixel stage runs
on CUDA unless --device names another torch device.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np

from . import api
from .host import obu as obu_mod
from .host.demux import container_fps, open_demuxer


def yuv_to_rgb(pic) -> np.ndarray:
    """BT.601 limited-range YUV -> RGB888, any layout/bitdepth.

    dav1dplay hands planes to SDL YUV textures; pygame has no YUV
    surface, so convert on the CPU (shift >8-bit down to 8 first).
    """
    shift = pic.bitdepth - 8
    y = pic.planes[0].astype(np.int32) >> shift
    h, w = y.shape
    if len(pic.planes) == 1:                    # monochrome
        u = v = np.full((h, w), 128, np.int32)
    else:
        u, v = (p.astype(np.int32) >> shift for p in pic.planes[1:])
        u = u.repeat(h // u.shape[0], 0).repeat(w // u.shape[1], 1)
        v = v.repeat(h // v.shape[0], 0).repeat(w // v.shape[1], 1)
    yf = (y - 16) * 298
    r = (yf + 409 * (v - 128) + 128) >> 8
    g = (yf - 100 * (u - 128) - 208 * (v - 128) + 128) >> 8
    b = (yf + 516 * (u - 128) + 128) >> 8
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def keyframe_tus(units) -> list[int]:
    """TU indices starting with a keyframe (seek targets)."""
    st = obu_mod.ObuState()
    keys = []
    for i, obus in enumerate(units):
        st.frame_hdr = None
        try:
            for o in obus:
                obu_mod.parse_obus(st, bytes(o))
        except Exception:
            # a TU that does not parse is no seek target
            continue
        if st.frame_hdr is not None and st.frame_hdr.frame_type == 0:
            keys.append(i)
    return keys


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="dav1d_mirror_tpu_torch.player")
    ap.add_argument("input")
    ap.add_argument("--untimed", action="store_true",
                    help="render as fast as decode allows")
    ap.add_argument("--frames", type=int, default=0,
                    help="stop after N frames (0 = all)")
    ap.add_argument("--null", action="store_true",
                    help="headless: SDL dummy driver, no window")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the pixel stage (default cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.null:
        os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
    import pygame

    data = Path(args.input).read_bytes()
    _, units = open_demuxer(data)
    units = list(units)
    keys = keyframe_tus(units)
    fps = container_fps(data) or (25, 1)
    frame_dt = fps[1] / fps[0] if fps[0] else 0.04

    dec = api.Decoder(api.Settings(device=args.device))

    pygame.init()
    screen = None
    clock_t0 = time.perf_counter()
    shown = 0
    paused = False
    pos = 0
    try:
        while True:
            for ev in pygame.event.get():
                if ev.type == pygame.QUIT:
                    return 0
                if ev.type == pygame.KEYDOWN:
                    if ev.key in (pygame.K_ESCAPE, pygame.K_q):
                        return 0
                    if ev.key == pygame.K_SPACE:
                        paused = not paused
                    if ev.key in (pygame.K_LEFT, pygame.K_RIGHT):
                        back = ev.key == pygame.K_LEFT
                        cands = [k for k in keys if
                                 (k < pos - 1 if back else k > pos)]
                        if cands:
                            pos = cands[-1] if back else cands[0]
                            dec.flush()
                            clock_t0, shown = time.perf_counter(), 0
            if paused:
                time.sleep(0.02)
                continue
            if pos >= len(units):
                break
            dec.send_obus(units[pos])
            pos += 1
            while (pic := dec.get_picture()) is not None:
                rgb = yuv_to_rgb(pic)
                h, w = rgb.shape[:2]
                if screen is None:
                    screen = pygame.display.set_mode((w, h))
                    pygame.display.set_caption(
                        f"dav1d_mirror_tpu_torch player — {w}x{h} "
                        f"{pic.bitdepth}-bit")
                surf = pygame.surfarray.make_surface(rgb.swapaxes(0, 1))
                if not args.untimed:       # pace to container fps
                    tgt = clock_t0 + shown * frame_dt
                    now = time.perf_counter()
                    if now < tgt:
                        time.sleep(tgt - now)
                screen.blit(surf, (0, 0))
                pygame.display.flip()
                shown += 1
                if args.frames and shown >= args.frames:
                    return 0
        dec.drain()
        while dec.get_picture() is not None:
            shown += 1
    finally:
        dec.close()
        el = time.perf_counter() - clock_t0
        print(f"played {shown} frames in {el:.2f}s "
              f"({shown / el:.1f} fps)", file=sys.stderr)
        pygame.quit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
