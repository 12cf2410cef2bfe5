"""Worker control plane: PI controller over engine-queue growth rates (SS5).

Every ``interval`` (30 ms default, as in the paper) the controller samples
both queue lengths, computes each queue's growth rate since the last tick,
and uses the growth-rate difference as the error signal of a
Proportional-Integral controller. A positive control signal re-assigns one
CPU core from the communication engines to the compute engines; negative,
the opposite. Engine pools never drop below one slot each.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from repro_torch.core.engines import COMM, COMPUTE, EngineSet
from repro_torch.core.sim import EventLoop


@dataclass
class PIController:
    engines: EngineSet
    loop: EventLoop
    interval_s: float = 0.030
    kp: float = 0.6
    ki: float = 0.2
    deadband: float = 0.5          # |u| below this: no action
    enabled: bool = True
    history: List[Tuple[float, int, int, float]] = field(default_factory=list)

    def __post_init__(self):
        self._last = self.engines.queue_lengths()
        self._integral = 0.0
        self._started = False

    def start(self):
        if not self._started:
            self._started = True
            self.loop.after(self.interval_s, self._tick, daemon=True)

    def _tick(self):
        cur = self.engines.queue_lengths()
        dt = self.interval_s
        growth_compute = (cur[COMPUTE] - self._last[COMPUTE]) / dt
        growth_comm = (cur[COMM] - self._last[COMM]) / dt
        self._last = cur

        error = (growth_compute - growth_comm) * dt  # per-tick units
        self._integral = 0.9 * self._integral + error
        u = self.kp * error + self.ki * self._integral

        moved = 0
        if self.enabled:
            if u > self.deadband:
                if self.engines.retype_one(COMM, COMPUTE):
                    moved = 1
                    self._integral = 0.0
            elif u < -self.deadband:
                if self.engines.retype_one(COMPUTE, COMM):
                    moved = -1
                    self._integral = 0.0
        counts = self.engines.counts()
        self.history.append((self.loop.now, counts[COMPUTE], counts[COMM], u))
        self.loop.after(self.interval_s, self._tick, daemon=True)
