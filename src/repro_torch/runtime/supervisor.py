"""Step-time watchdog of the serving engine.

Port of ``WatchdogEvent`` :31 and ``StragglerWatchdog`` :52-98 of
``repro/runtime/supervisor.py``.  The training ``Supervisor`` of that
module is not ported (ROADMAP open item 1.11, training and checkpoints).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class WatchdogEvent:
    """One watchdog emission: ``kind`` is ``"straggler"`` (a slow step,
    below patience) or ``"hung"`` (``consecutive`` slow steps reached
    patience: the caller acts; the engine preempts with spill).
    ``phases`` optionally splits the observed step's time."""
    kind: str
    dt: float
    ema: float
    consecutive: int
    phases: dict | None = None


class StragglerWatchdog:
    """A step slower than ``ratio`` times the median of the trailing
    ``window`` steps is flagged; ``patience`` consecutive flags escalate
    to a ``hung`` event.  The baseline is a median, so one slow step (a
    first-use kernel build, a calibration) does not mask a hung one for
    the next ``window`` steps.  The policy stays with the caller."""

    def __init__(self, ratio: float = 5.0, patience: int = 3,
                 window: int = 8, on_event=None):
        self.ratio = ratio
        self.patience = patience
        self.window = window
        self.on_event = on_event
        self.step_times: list[float] = []
        self.events = 0                      # consecutive flagged steps
        self.event_log: list[WatchdogEvent] = []

    def observe(self, dt: float,
                phases: dict | None = None) -> WatchdogEvent | None:
        ev = None
        if len(self.step_times) >= self.window:
            ema = float(np.median(self.step_times[-self.window:]))
            if dt > self.ratio * max(ema, 1e-6):
                self.events += 1
                kind = "hung" if self.events >= self.patience \
                    else "straggler"
                ev = WatchdogEvent(kind=kind, dt=dt, ema=ema,
                                   consecutive=self.events, phases=phases)
            else:
                self.events = 0
        self.step_times.append(dt)
        if ev is not None:
            self.event_log.append(ev)
            if self.on_event is not None:
                self.on_event(ev)
        return ev

    def reset(self) -> None:
        self.events = 0
