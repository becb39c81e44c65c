"""What one run measured, handed to the metric readers, and the checks
that decide ``correct``."""

import dataclasses
import math


@dataclasses.dataclass
class Run:
    cell: dict
    config: dict
    seed: int
    seconds: float
    device: str = "cuda"
    setup_s: float = None
    window_s: float = None          # the measured window's seconds
    frames: int = 0                 # frames (or images) handed back in it
    latencies_s: list = dataclasses.field(default_factory=list)
    steps: int = 0                  # train steps completed in it
    samples: int = 0
    attempted: int = 0
    failed: int = 0
    dispatch_s: list = dataclasses.field(default_factory=list)
    step_dispatch_s: list = dataclasses.field(default_factory=list)
    data_wait_s: list = dataclasses.field(default_factory=list)
    peak_bytes: int = None
    trace: object = None            # core.trace.Trace of the traced span
    launches: dict = dataclasses.field(default_factory=dict)
    launch_units: tuple = ("frame", 0)   # what the launches are counted per
    work: dict = dataclasses.field(default_factory=dict)
    checks: dict = dataclasses.field(default_factory=dict)
    notes: list = dataclasses.field(default_factory=list)

    def check(self, name, value, limit):
        """A number compared with its limit (it must not exceed it)."""
        self.checks[name] = {"value": value, "limit": limit}

    @property
    def correct(self):
        return bool(self.checks) and all(
            isinstance(c["value"], (int, float)) and math.isfinite(c["value"])
            and c["value"] <= c["limit"] for c in self.checks.values())


def gap_by_leaf(program, reference, held, floor):
    """The widest gap between the program's and the reference's norm of a
    leaf, against the reference's norm of that leaf or ``floor`` (the
    median leaf's), whichever is larger."""
    return max(abs(program.get(k, 0.0) - reference[k])
               / max(reference[k], floor) for k in held)
