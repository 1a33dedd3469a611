"""Training supervisor (checkpoint/restart fault tolerance, preemption
signals, the straggler watchdog) and the watchdog the serving engine
shares.

Port of ``repro/runtime/supervisor.py``: ``WatchdogEvent`` :31,
``StragglerWatchdog`` :52-98, ``SupervisorConfig`` :100 and ``Supervisor``
:116-224.  The supervisor catches a failed step, restores the latest
atomic checkpoint (on its device), and continues; with deterministic
steps the result equals an uninterrupted run bit for bit.
"""
from __future__ import annotations

import dataclasses
import logging
import signal
import time
from typing import Any, Callable

import numpy as np

from repro_torch.ckpt import checkpoint as ckpt

log = logging.getLogger("repro_torch.supervisor")


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


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_dir: str
    save_every: int = 100
    max_steps: int = 1000
    keep: int = 3
    compress_ckpt: bool = False
    max_restarts: int = 10
    # a step slower than ratio x the trailing median is flagged; after
    # ``straggler_patience`` consecutive flags it is treated as hung (on a
    # cluster: backup workers or a re-mesh; here: raise)
    straggler_ratio: float = 5.0
    straggler_patience: int = 3
    async_save: bool = True


class Supervisor:
    def __init__(self, cfg: SupervisorConfig, *,
                 make_state: Callable[[], tuple[Any, dict]],
                 step_fn: Callable[[Any, int], tuple[Any, dict]],
                 data_state: Callable[[], dict] | None = None,
                 restore_data: Callable[[dict], None] | None = None,
                 on_watchdog_event: Callable[[WatchdogEvent], None]
                 | None = None,
                 device=None, ckpt_timings: dict | None = None):
        """Args:
          make_state: () -> (train_state, extra), a fresh initialization.
          step_fn: (train_state, step_idx) -> (train_state, metrics).
          data_state / restore_data: the data pipeline's cursor hooks.
          on_watchdog_event: sink of straggler/hung events.
          device: where a restored state's leaves go and the checkpoint
            codec runs (the card unless the caller asks for the CPU).
          ckpt_timings: ``{"save": {}, "restore": {}}``, filled with the
            checkpoints' part seconds (``ckpt.checkpoint``).
        """
        self.cfg = cfg
        self.make_state = make_state
        self.step_fn = step_fn
        self.data_state = data_state or (lambda: {})
        self.restore_data = restore_data or (lambda s: None)
        self.device = device
        self.ckpt_timings = ckpt_timings or {"save": None, "restore": None}
        self.preempted = False
        self.restarts = 0
        self.watchdog = StragglerWatchdog(ratio=cfg.straggler_ratio,
                                          patience=cfg.straggler_patience,
                                          on_event=on_watchdog_event)
        self._saver = ckpt.AsyncCheckpointer(
            cfg.ckpt_dir, compress=cfg.compress_ckpt, keep=cfg.keep,
            device=device, timings=self.ckpt_timings["save"])

    @property
    def step_times(self) -> list[float]:
        return self.watchdog.step_times

    @property
    def straggler_events(self) -> int:
        return self.watchdog.events

    @straggler_events.setter
    def straggler_events(self, v: int) -> None:
        self.watchdog.events = v

    def _install_signal_handler(self):
        def handler(signum, frame):
            log.warning("preemption signal %s received", signum)
            self.preempted = True
        try:
            signal.signal(signal.SIGTERM, handler)
            signal.signal(signal.SIGUSR1, handler)
        except ValueError:
            pass                                   # not the main thread

    def _resume_or_init(self):
        if ckpt.latest_step(self.cfg.ckpt_dir) is not None:
            state, extra, step = ckpt.restore(
                self.cfg.ckpt_dir, device=self.device,
                timings=self.ckpt_timings["restore"])
            self.restore_data(extra.get("data", {}))
            log.info("restored step %d from %s", step, self.cfg.ckpt_dir)
            return state, step
        state, _ = self.make_state()
        return state, 0

    def _watchdog(self, dt: float) -> None:
        ev = self.watchdog.observe(dt)
        if ev is not None:
            log.warning("straggler step: %.3fs vs median %.3fs "
                        "(%d consecutive)", ev.dt, ev.ema, ev.consecutive)
            if ev.kind == "hung":
                raise TimeoutError(
                    "persistent straggler: on a cluster this triggers "
                    "backup-worker promotion or a re-mesh")

    def _save(self, step: int, state: Any) -> None:
        extra = {"data": self.data_state(), "wall_time": time.time()}
        if self.cfg.async_save:
            self._saver.save(step, state, extra)
        else:
            ckpt.save(self.cfg.ckpt_dir, step, state, extra,
                      compress=self.cfg.compress_ckpt, keep=self.cfg.keep,
                      device=self.device, timings=self.ckpt_timings["save"])

    def run(self) -> tuple[Any, list[dict]]:
        """Run to ``max_steps`` with restart on failure.  Returns (state,
        the metrics of every completed step, a replayed one again)."""
        self._install_signal_handler()
        history: list[dict] = []
        state, step = self._resume_or_init()
        while step < self.cfg.max_steps and not self.preempted:
            t0 = time.time()
            try:
                state, metrics = self.step_fn(state, step)
            except (TimeoutError, RuntimeError, ValueError,
                    FloatingPointError) as e:
                self.restarts += 1
                log.error("step %d failed (%s); restart %d/%d", step, e,
                          self.restarts, self.cfg.max_restarts)
                if self.restarts > self.cfg.max_restarts:
                    raise
                self._saver.wait()
                state, step = self._resume_or_init()
                self.straggler_events = 0
                continue
            dt = time.time() - t0
            self._watchdog(dt)
            step += 1
            metrics = dict(metrics)
            metrics.update(step=step, dt=dt)
            history.append(metrics)
            if step % self.cfg.save_every == 0 or step == self.cfg.max_steps:
                self._save(step, state)
        if self.preempted:
            self._save(step, state)
        self._saver.wait()
        return state, history
