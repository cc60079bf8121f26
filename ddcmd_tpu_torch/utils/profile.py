"""Named phase timers (profile/ptiming analog).

Counterpart of ddcmd_tpu/utils/profile.py (reference: ~120 enum'd phase
timers written per rank into each snapshot, ddcMD src/ptiming.h:10-36,
profile.c:468).  A process-global registry of named accumulating host
timers and counters, dumped as a `profile` table into snapshot
directories.  CUDA work is asynchronous, so a timer brackets host spans
that end in a device sync where the caller needs device time
(Simulation.run's dispatches end in one; Simulation.profile_phases
synchronises after its calls); per-kernel device time comes from a
torch.profiler trace (start_trace / stop_trace).
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from dataclasses import dataclass


@dataclass
class Timer:
    name: str
    total: float = 0.0
    calls: int = 0
    _t0: float = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        self.total += time.perf_counter() - self._t0
        self.calls += 1


class Profile:
    def __init__(self):
        self.timers: dict[str, Timer] = {}
        self.counters: dict[str, float] = {}
        self.t_init = time.perf_counter()

    def timer(self, name: str) -> Timer:
        if name not in self.timers:
            self.timers[name] = Timer(name)
        return self.timers[name]

    @contextmanager
    def phase(self, name: str):
        t = self.timer(name)
        t.start()
        try:
            yield
        finally:
            t.stop()

    def count(self, name: str, value: float = 1.0):
        self.counters[name] = self.counters.get(name, 0.0) + value

    def table(self) -> str:
        total = time.perf_counter() - self.t_init
        lines = [f"{'phase':<28} {'calls':>10} {'total(s)':>12} "
                 f"{'avg(ms)':>12} {'%':>7}"]
        for t in sorted(self.timers.values(), key=lambda t: -t.total):
            avg = t.total / t.calls * 1e3 if t.calls else 0.0
            lines.append(f"{t.name:<28} {t.calls:>10d} {t.total:>12.4f} "
                         f"{avg:>12.3f} {100 * t.total / total:>6.1f}%")
        for k, v in sorted(self.counters.items()):
            lines.append(f"{k:<28} {v:>10.0f}")
        lines.append(f"{'WALL':<28} {'':>10} {total:>12.4f}")
        return "\n".join(lines)

    def write(self, snapdir: str):
        """dumpprofile analog (ddcMD src/ddcMD.c:209-223)."""
        with open(os.path.join(snapdir, "profile"), "w") as f:
            f.write(self.table() + "\n")


#: process-global instance (the reference's profile() is global too)
PROFILE = Profile()


def start_trace(logdir: str):
    """Start a torch.profiler trace of the host and, with a card, the
    CUDA kernels; returns the profiler for stop_trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    return prof


def stop_trace(prof, logdir: str) -> str:
    """Stop the trace start_trace began and write it as a Chrome trace
    into logdir; returns the file's path."""
    prof.stop()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    return path
