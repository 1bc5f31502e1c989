"""Summed stage seconds over the stage stretch's wall seconds: above 1
where the pipelined decoder's threads run stages side by side."""
from harness.record import stretch_wall_s


def read(rec):
    if not rec.stages:
        return None
    wall = stretch_wall_s(rec.stage_stretch)
    return sum(rec.stages.values()) / wall if wall > 0 else None
