"""Runtime invariant reporting, matching the reference stats block.

The reference prints every 0.1 sim-seconds (`pi_sph_fluid.c:679-691`):

    sim time: 1.20, ticks/s: 4102, max rho error: 0.3% (worst) 1.2%, ...

Fields are replicated exactly (plus the neighbor-overflow counter this
framework adds), with the reference's max-density comparison bug fixed —
it compared rho against an error so the "max" was the last particle's
rho-rho0 (`pi_sph_fluid.c:658-659`, SURVEY.md §2 #16); we report the true
max.  Reductions happen on device (models/simulation.py stats).

Accumulation is **lazy**: per-dispatch updates only enqueue tiny device
maximums; the host materializes them when a report line is due (every 0.1
sim-seconds) or when the worst-case properties are read.  A per-dispatch
host sync would serialize the dispatch pipeline, and at the reference's
269-particle operating point the round trip costs more than the steps.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

__all__ = ["StatsReporter"]


@dataclass
class StatsReporter:
    dt: float
    report_every_sim_s: float = 0.1
    stream: object = None

    t: float = 0.0
    _last_report_t: float = 0.0
    _last_report_wall: float = field(default_factory=time.perf_counter)
    _worst_rho: object = 0.0      # device or python scalars; max-merged lazily
    _worst_speed: object = 0.0
    _overflow: object = 0
    _overflow_by: object = None   # (4,) [window, halo, mig, slab] or None
    _stale: object = 0            # sticky-layout staleness-guard trips
    _window_rho: object = 0.0
    _window_speed: object = 0.0

    _pending: list = field(default_factory=list)

    @property
    def worst_rho_error_pct(self) -> float:
        self._drain()
        return float(self._worst_rho)

    @property
    def worst_speed(self) -> float:
        self._drain()
        return float(self._worst_speed)

    @property
    def total_overflow(self) -> int:
        self._drain()
        return int(self._overflow)

    @property
    def total_overflow_by(self):
        """Per-capacity overflow attribution [window, halo, mig, slab]
        (np.int64 (4,)), or None when the backend reports only the
        aggregate.  Drives targeted elastic recovery on the dd backend."""
        self._drain()
        return None if self._overflow_by is None else self._overflow_by.copy()

    @property
    def total_stale(self) -> int:
        """Sticky-layout staleness-guard trips (particle-ticks whose drift
        since the group's layout exceeded the 0.3*H fringe margin — see
        models.simulation.StepStats.stale).  Nonzero means resort_every is
        too high for the current flow speed; SimRunner's elastic recovery
        responds by halving it and replaying."""
        self._drain()
        return int(self._stale)

    def _drain(self):
        """Fold pending device stats into the host-side aggregates."""
        for st in self._pending:
            rho = float(np.max(np.asarray(st.max_rho_error_pct)))
            speed = float(np.max(np.asarray(st.max_speed)))
            ov = int(np.sum(np.asarray(st.neighbor_overflow)))
            self._window_rho = max(float(self._window_rho), rho)
            self._window_speed = max(float(self._window_speed), speed)
            self._worst_rho = max(float(self._worst_rho), rho)
            self._worst_speed = max(float(self._worst_speed), speed)
            self._overflow = int(self._overflow) + ov
            ovb = getattr(st, "overflow_by", None)
            if ovb is not None:
                ovb = np.asarray(ovb, np.int64).reshape(-1, 4).sum(axis=0)
                base = (np.zeros(4, np.int64) if self._overflow_by is None
                        else self._overflow_by)
                self._overflow_by = base + ovb
            stale = getattr(st, "stale", None)
            if stale is not None:
                self._stale = int(self._stale) + int(
                    np.sum(np.asarray(stale, np.int64)))
        self._pending.clear()

    def snapshot(self) -> tuple:
        """Drain and capture the host-side aggregates (for revert/replay:
        io/host_loop.SimRunner's elastic-capacity recovery rewinds the
        reporter alongside the sim state)."""
        self._drain()
        ovb = None if self._overflow_by is None else self._overflow_by.copy()
        return (self.t, self._last_report_t, float(self._worst_rho),
                float(self._worst_speed), int(self._overflow), ovb,
                int(self._stale))

    def restore(self, snap: tuple) -> None:
        (self.t, self._last_report_t, self._worst_rho,
         self._worst_speed, self._overflow, self._overflow_by,
         self._stale) = snap
        self._window_rho = 0.0
        self._window_speed = 0.0
        self._pending.clear()
        self._last_report_wall = time.perf_counter()

    def update(self, n_steps: int, step_stats) -> str | None:
        """Feed one dispatch's StepStats (scalars or (k,) arrays from scan);
        returns a formatted report line when one is due.  Enqueues NOTHING
        and never blocks between reports: per-dispatch host work (even one
        tiny jnp op) serializes the dispatch pipeline through its
        per-executable latency."""
        self._pending.append(step_stats)
        self.t += n_steps * self.dt

        if self.t - self._last_report_t < self.report_every_sim_s:
            return None
        self._drain()
        now = time.perf_counter()
        elapsed = now - self._last_report_wall
        tps = int((self.t - self._last_report_t) / self.dt / max(elapsed, 1e-9))
        wrho = float(self._window_rho)
        wspeed = float(self._window_speed)
        line = (
            f"sim time: {self.t:.2f}, ticks/s: {tps}, "
            f"max rho error: {wrho:.3f}% (worst) {float(self._worst_rho):.3f}%, "
            f"max speed: {wspeed:.1f} m/s (worst) {float(self._worst_speed):.1f} m/s"
        )
        total_ov = int(self._overflow)
        if total_ov:
            line += f", NEIGHBOR OVERFLOW: {total_ov}"
        if int(self._stale):
            line += f", STALE DRIFT: {int(self._stale)}"
        self._last_report_t = self.t
        self._last_report_wall = now
        self._window_rho = 0.0
        self._window_speed = 0.0
        if self.stream is not None:
            print(line, file=self.stream, flush=True)
        return line
