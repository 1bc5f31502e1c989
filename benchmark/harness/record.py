"""What a run recorded, as the metric readers see it."""
from __future__ import annotations

from dataclasses import dataclass, field

from .drive import Stretch
from .spec import Cell
from .trace import Profile


@dataclass
class Record:
    cell: Cell
    device_name: str
    setup_s: float
    # the window's stretches: one untraced; traced, the stage stretch and
    # the profile stretch
    stretches: list = field(default_factory=list)
    # the stage stretch's {stage: seconds} and the profile (traced runs)
    stages: dict | None = None
    profile: Profile | None = None

    @property
    def stage_stretch(self) -> Stretch | None:
        return self.stretches[0] if len(self.stretches) == 2 else None

    @property
    def profile_stretch(self) -> Stretch | None:
        return self.stretches[1] if len(self.stretches) == 2 else None

    def pictures(self) -> list:
        """Every picture returned inside the window."""
        return [p for s in self.stretches for p in s.in_window()]

    def visits(self) -> list:
        return [v for s in self.stretches for v in s.visits]


def all_pictures(stretch: Stretch) -> list:
    """Every picture of a stretch, those taken after its close too: the
    work its stage totals and its profile hold."""
    return [p for v in stretch.visits for p in v.pictures]


def stretch_wall_s(stretch: Stretch) -> float:
    """From the stretch's start to its last picture, late ones too."""
    pics = all_pictures(stretch)
    return max(p.t for p in pics) - stretch.t0 if pics else 0.0


def stage_ms_per_frame(rec: Record, stage: str) -> float | None:
    """A decoder stage's milliseconds a picture over the stage stretch;
    None where the stage never ran there."""
    if rec.stages is None or not rec.stages.get(stage):
        return None
    n = len(all_pictures(rec.stage_stretch))
    return rec.stages[stage] * 1e3 / n if n else None


def profile_per_frame(rec: Record, value: float) -> float | None:
    """`value` over the pictures of the profile stretch."""
    if rec.profile is None:
        return None
    n = len(all_pictures(rec.profile_stretch))
    return value / n if n else None
