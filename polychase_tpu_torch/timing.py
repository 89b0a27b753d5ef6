"""Device time and device work of a function on a CUDA card, for
``chip_smoke.py`` and the port's measuring tools (``crossover``,
``k5_compare``).  It imports nothing of the port, so a tool can load it by
its path beside a checkout of another commit.

``event_ms(fn, reps)`` runs ``fn`` once, then queues ``reps`` calls behind
a device sleep and returns the mean milliseconds a call between two CUDA
events: the calls queue while the card sleeps, so the events time the
device's work, not the host's issue rate.  ``device_work(fn)`` lists what
one call queued and ran on the device, under ``torch.profiler``.
"""

from __future__ import annotations

import torch

# Cycles the device sleeps before a timed run (20 ms at the H100's 1980 MHz
# at most): the run's launches queue behind it, so the events time the
# device's work, not the host's issue rate (K1 takes less time than its
# wrapper's host side, ~40 us a call, and a run issues up to 100 calls).
SLEEP_CYCLES = 40_000_000


def event_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``reps`` calls of ``fn`` on the current
    card, after one call outside the timing."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


QUEUED = ("cudaLaunch", "cudaMemcpy", "cudaMemset")


def device_work(fn):
    """What ``fn`` queued on the device, under ``torch.profiler``: the CUDA
    runtime's kernel launches, copies and fills (its API calls, which the
    profiler records as they are made) and the device's kernels, copies and
    fills as (name, ms) (which it may miss in a window this short).  ``fn``
    runs once under a first profiler, which is thrown away, so that the
    profiler's own set-up falls outside the window read.  Returns (queued,
    ran, what the second call of ``fn`` returned)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
    host = {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU}
    events = list(prof.profiler.kineto_results.events())
    queued = [e.name() for e in events
              if e.device_type() == torch.autograd.DeviceType.CPU
              and e.name().startswith(QUEUED)]
    ran = [(e.name(), (e.end_ns() - e.start_ns()) / 1e6) for e in events
           if e.device_type() == torch.autograd.DeviceType.CUDA
           and e.name() not in host]
    return queued, ran, out
