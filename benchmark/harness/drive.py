"""The window: one ``api.Decoder`` driven as a player or transcoder
drives it, one stream in flight, closed loop.

Each stream of the seeded order starts with ``flush()`` (a seek or a
playlist change); each temporal unit goes in with ``send_data``, and a
picture is taken with ``get_picture`` once the decoder's frame delay
(``api.get_frame_delay``) of frames is pending, as dav1d's frame delay
has it: 1 takes each picture right after its frame, and a pipelined
decoder keeps that many frames in flight. At a stream's end ``drain()``
and ``get_picture`` until it returns nothing. Once a picture returns at
or after the window's close no further unit is sent; the pictures still
due are taken, late, and compared, but not counted in the window.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class Picture:
    planes: tuple        # the visible planes as the user receives them
    bitdepth: int
    t: float             # perf_counter when get_picture returned it
    latency_s: float     # from the send of its temporal unit
    late: bool           # returned at or after the window's close


@dataclass
class Visit:
    """One pass over one pool stream."""
    stream: int          # index in the pool
    sent: int = 0        # temporal units sent, each due one picture
    pictures: list = field(default_factory=list)
    first_picture_s: float | None = None    # from flush()


@dataclass
class Stretch:
    t0: float
    seconds: float
    visits: list = field(default_factory=list)

    def in_window(self) -> list:
        return [p for v in self.visits for p in v.pictures if not p.late]

    def fps(self) -> float | None:
        """Pictures returned in the window over the time up to the last
        of them."""
        pics = self.in_window()
        if not pics:
            return None
        return len(pics) / (max(p.t for p in pics) - self.t0)


def _null_span(_name):
    return contextlib.nullcontext()


def drive(dec, pool, order, delay: int, seconds: float,
          span=_null_span) -> Stretch:
    """Decode streams of `pool` in `order` (an iterator of pool indices)
    for `seconds`. `span(name)` wraps each call into the decoder (a
    profiler annotation in a traced run)."""
    now = time.perf_counter
    out = Stretch(now(), seconds)
    deadline = out.t0 + seconds
    closed = False
    while not closed:
        visit = Visit(next(order))
        out.visits.append(visit)
        sends = []
        t_flush = now()
        with span("flush"):
            dec.flush()

        def take() -> bool:
            nonlocal closed
            with span("get_picture"):
                pic = dec.get_picture()
            if pic is None:
                return False
            t = now()
            i = len(visit.pictures)
            late = closed or t >= deadline
            visit.pictures.append(Picture(
                pic.planes, pic.bitdepth, t,
                t - sends[i] if i < len(sends) else float("nan"), late))
            if i == 0:
                visit.first_picture_s = t - t_flush
            closed = closed or late
            return True

        for unit in pool[visit.stream].units:
            if closed:
                break
            sends.append(now())
            with span("send_data"):
                dec.send_data(unit)
            visit.sent += 1
            while visit.sent - len(visit.pictures) >= delay and take():
                pass
        dec.drain()
        while take():
            pass
    return out
