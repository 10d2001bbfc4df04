"""Where a repeated step's time goes on the card, from ``torch.profiler``."""

from __future__ import annotations

import sys
from typing import Any, Callable

import torch

#: traced sessions before a trace that lost device records is taken as it
#: is, or, when it holds none, raises.  The profiler (kineto) drops a device
#: record whose time falls outside its capture window (``Record counts:
#: Out-of-range`` under ``KINETO_LOG_LEVEL=1``).  In a whole
#: ``chip_smoke.py`` run on the card the records a kept session lost grew
#: with the process's age, from 0-3 to 53, and phase M1's session of five
#: WKV backward calls lost all 20 in its first session in every run and
#: none in its second (and all in each of three sessions once)
SESSIONS = 5

#: the share of a session's CUDA runtime launch calls that may lack a
#: device record before the session is traced again; a session that lost
#: as many as the one before it is not traced again either
LOST_SHARE = 0.01

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
    the idle share of the window.  A session with fewer device records than
    CUDA runtime launch calls (when it holds no graph launch) lost records;
    when it lost all, or more than :data:`LOST_SHARE` of them and not as
    many as the session before it, it is reported on stderr and traced
    again, up to :data:`SESSIONS`.  The last session is taken as
    it is if it holds any device record, and raises if it holds none, as a
    run without a card does at once, so a CPU run is never reported as a
    device time.  ``sessions`` is the number of sessions traced (1 for a
    clean measurement), also logged in :data:`TRACES`; ``short_sessions``
    says, for each session traced again, how many host events, CUDA runtime
    launch calls and device records it kept, and ``missing_records`` how
    many launch calls the returned session holds beyond its device records.
    ``clock_check`` holds two gaps that a card idle before the first launch
    and synchronized after the last makes small and positive, the first
    device activity's start less the first launch call's and the last
    synchronize's end less the last device activity's end: a shift between
    the trace's device and host clocks moves them apart by its size."""
    from torch.profiler import ProfilerActivity, profile

    step()
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    short: list[dict] = []
    last_missing = None
    for session in range(1, SESSIONS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n_cycles):
                step()
            if cuda:
                torch.cuda.synchronize()
        events = prof.events()
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        launch_calls = [e.name for e in events if e.name in _LAUNCH_CALLS]
        missing = (0 if "cudaGraphLaunch" in launch_calls
                   else max(0, len(launch_calls) - len(device)))
        if not cuda or (device and (missing <= LOST_SHARE * len(launch_calls)
                                    or missing == last_missing)):
            break
        last_missing = missing
        short.append({"host_events": len(events) - len(device),
                      "runtime_launches": len(launch_calls), "device_records": len(device)})
        print(f"device_breakdown: session {session} of {SESSIONS} lost device records "
              f"({short[-1]})", file=sys.stderr, flush=True)
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
    TRACES.append({"sessions": session, **clock_check, "window_us": window,
                   "missing_records": missing})
    return {
        "cycles": n_cycles, "sessions": session, "short_sessions": short,
        "missing_records": missing,
        "clock_check": clock_check,
        "window_us_per_cycle": window / n_cycles,
        "busy_us_per_cycle": busy / n_cycles, "idle_share": 1.0 - busy / window,
        "kernels": [{"name": n, "us_per_cycle": us, "launches_per_cycle": c}
                    for n, us, c in kernels],
    }
