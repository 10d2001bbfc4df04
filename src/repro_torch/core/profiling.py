"""Where a repeated step's time goes on the card, from ``torch.profiler``."""

from __future__ import annotations

from typing import Any, Callable

import torch


def device_breakdown(step: Callable[[], Any], *, n_cycles: int = 3) -> dict:
    """Run ``step`` once to warm up, then trace ``n_cycles`` calls of it,
    synchronizing the card after the last.  Returns per-call ("per cycle")
    device time by kernel name (with launches per call), the traced window,
    the device-busy time (union of kernel, memcpy and memset intervals) and
    the idle share of the window.  Raises when the trace holds no device
    activity, so a CPU run is never reported as a device time."""
    from torch.profiler import ProfilerActivity, profile

    step()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_cycles):
            step()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
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
    return {
        "cycles": n_cycles, "window_us_per_cycle": window / n_cycles,
        "busy_us_per_cycle": busy / n_cycles, "idle_share": 1.0 - busy / window,
        "kernels": [{"name": n, "us_per_cycle": us, "launches_per_cycle": c}
                    for n, us, c in kernels],
    }
