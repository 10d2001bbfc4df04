"""Where a repeated step's time goes on the card, from ``torch.profiler``."""

from __future__ import annotations

import sys
from typing import Any, Callable

import torch

#: traced sessions before a trace without device activity raises: on the
#: card a session has now and then recorded none for a step of CUDA-graph
#: replays late in a long run (``chip_smoke.py`` phase E, twice in four
#: whole runs; the cause is not known), where the same step's next session
#: may record them
SESSIONS = 3

#: CUDA runtime calls that put work on the card, and the synchronize that
#: ends a traced window
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                 "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")
_SYNC_CALL = "cudaDeviceSynchronize"

#: one entry a :func:`device_breakdown` call of this process, in call
#: order: the sessions it took, its ``clock_check`` and its traced window
#: in microseconds, so a run's record shows every measurement that was
#: traced again and where the trace's clocks stood
TRACES: list[dict] = []


def device_breakdown(step: Callable[[], Any], *, n_cycles: int = 3) -> dict:
    """Run ``step`` once to warm up, then trace ``n_cycles`` calls of it,
    synchronizing the card after the last.  Returns per-call ("per cycle")
    device time by kernel name (with launches per call), the traced window,
    the device-busy time (union of kernel, memcpy and memset intervals) and
    the idle share of the window.  A session on the card that records no
    device activity is reported on stderr and traced again, up to
    :data:`SESSIONS`; then, or at once without a card, it raises, so a CPU
    run is never reported as a device time.  ``sessions`` is the number of
    sessions traced (1 for a clean measurement), also logged in
    :data:`TRACES`; ``empty_sessions`` says, for each one without
    device activity, how many host events and CUDA runtime launch calls it
    did record.  ``clock_check`` holds two gaps that a card idle before
    the first launch and synchronized after the last makes small and
    positive, the first device activity's start less the first launch
    call's and the last synchronize's end less the last device activity's
    end: a shift between the trace's device and host clocks moves them
    apart by its size."""
    from torch.profiler import ProfilerActivity, profile

    step()
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    empty: list[dict] = []
    for session in range(1, SESSIONS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n_cycles):
                step()
            if cuda:
                torch.cuda.synchronize()
        events = prof.events()
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        if device or not cuda:
            break
        empty.append({"host_events": len(events),
                      "runtime_launches": sum(e.name in _LAUNCH_CALLS for e in events)})
        print(f"device_breakdown: session {session} of {SESSIONS} recorded no device activity "
              f"({empty[-1]})", file=sys.stderr, flush=True)
    if not device:
        TRACES.append({"sessions": session, "failed": True})
        raise RuntimeError("the profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy, cur_start, cur_end = 0.0, *spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start = start
        cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events))
    by_name: dict[str, list[float]] = {}
    for e in device:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.end - e.time_range.start
        acc[1] += 1
    kernels = sorted(((name, us / n_cycles, n / n_cycles) for name, (us, n) in by_name.items()),
                     key=lambda row: -row[1])
    launches = [e.time_range.start for e in events if e.name in _LAUNCH_CALLS]
    syncs = [e.time_range.end for e in events if e.name == _SYNC_CALL]
    clock_check = {
        "first_launch_to_device_us": spans[0][0] - min(launches) if launches else None,
        "last_device_to_sync_end_us": (max(syncs) - max(e.time_range.end for e in device)
                                       if syncs else None)}
    TRACES.append({"sessions": session, **clock_check, "window_us": window})
    return {
        "cycles": n_cycles, "sessions": session, "empty_sessions": empty,
        "clock_check": clock_check,
        "window_us_per_cycle": window / n_cycles,
        "busy_us_per_cycle": busy / n_cycles, "idle_share": 1.0 - busy / window,
        "kernels": [{"name": n, "us_per_cycle": us, "launches_per_cycle": c}
                    for n, us, c in kernels],
    }
