"""What a traced run reads from ``torch.profiler``.

The device's busy time is the union of the intervals of every kernel, copy
and fill it ran, whether a torch op launched it or not (the program's
kernels launch through ctypes, outside any op); a ``record_function``
label's device time is that of the work under the ops it encloses.  Both
are reckoned as ``chip_smoke.profile_split`` reckons them, as a frozen
copy.  The device spans that the profiler draws for labels carry their
host range's name, which no kernel shares, and are left out.

Idle gaps are charged to the innermost host event open at the gap's
middle: a torch op, a CUDA runtime call or one of the benchmark's own
``bench.*`` labels (``host`` where none is open).
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

WINDOW_LABEL = "bench.window"
TOP = 10
# Host events walked back from a moment in search of one still open then.
_WALK = 4096


@dataclass
class Trace:
    window_s: float
    busy_s: float
    labels: dict = field(default_factory=dict)    # label → device ms
    kernels: dict = field(default_factory=dict)   # device op → ms
    idle_gaps: list = field(default_factory=list)  # [(host event, s)]

    def device_ops(self):
        return [[n, ms / 1e3] for n, ms in sorted(
            self.kernels.items(), key=lambda kv: -kv[1])[:TOP]]

    def kernel_ms(self, *names) -> float:
        """Device ms of the device ops whose names hold any of ``names``."""
        return sum(ms for n, ms in self.kernels.items()
                   if any(k in n for k in names))


def _union(spans):
    out = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _innermost(cpu, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - _WALK, -1), -1):
        s, e, name = cpu[j]
        if e > t:
            return name
    return "host"


def traced(fn, device):
    """Run ``fn`` under ``torch.profiler`` inside the ``bench.window``
    label; returns what ``fn`` returned and the :class:`Trace`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW_LABEL):
            out = fn()
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    cpu_avg = prof.key_averages()
    labels = {e.key: e.device_time_total / 1e3 for e in cpu_avg}
    events = list(prof.profiler.kineto_results.events())
    host = [e for e in events
            if e.device_type() == torch.autograd.DeviceType.CPU]
    host_names = {e.name() for e in host}
    window = [(e.start_ns(), e.end_ns()) for e in host
              if e.name() == WINDOW_LABEL]
    w0, w1 = window[0] if window else (None, None)
    dev = [e for e in events
           if e.device_type() == torch.autograd.DeviceType.CUDA
           and e.name() not in host_names]
    if w0 is None:
        w0 = min((e.start_ns() for e in dev), default=0)
        w1 = w0 + int(wall * 1e9)
    kernels = {}
    spans = []
    for e in dev:
        lo, hi = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if hi <= lo:
            continue
        spans.append((lo, hi))
        kernels[e.name()] = kernels.get(e.name(), 0.0) + (hi - lo) / 1e6
    busy = _union(spans)
    busy_ns = sum(hi - lo for lo, hi in busy)
    cpu = sorted((e.start_ns(), e.end_ns(), e.name()) for e in host
                 if e.name() != WINDOW_LABEL)
    starts = [c[0] for c in cpu]
    gaps, prev = {}, w0
    for lo, hi in busy + [[w1, w1]]:
        if lo > prev:
            name = _innermost(cpu, starts, (prev + lo) // 2)
            gaps[name] = gaps.get(name, 0.0) + (lo - prev) / 1e9
        prev = max(prev, hi)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return out, Trace((w1 - w0) / 1e9, busy_ns / 1e9, labels, kernels,
                      [[n, s] for n, s in idle])
