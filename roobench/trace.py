"""The measured window and, in a traced run, the device trace over it.

A traced run opens its own ``torch.profiler`` (host and device activity)
just before the window and reads the recorded events in memory when the
window closes. It fails when the profiler recorded no device activity: a
run that cannot see the card reports no device number.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[int, int]          # (start_ns, end_ns)


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def union_ns(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of closed intervals, as sorted disjoint intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def gaps_ns(busy: Sequence[Interval]) -> List[Interval]:
    """The idle gaps between consecutive busy intervals."""
    return [(a[1], b[0]) for a, b in zip(busy[:-1], busy[1:]) if b[0] > a[1]]


def label_gaps(gaps: Sequence[Interval],
               host_ops: Sequence[Tuple[str, int, int]]
               ) -> Dict[str, float]:
    """Seconds of device idle time by what the host was doing: each gap
    goes to the host op that overlaps it most (the innermost on a tie), or
    to "host (no op)"."""
    import bisect
    gaps = sorted(gaps)
    ends = [e for _, e in gaps]
    best: List[Optional[tuple]] = [None] * len(gaps)
    for name, s, e in host_ops:
        i = bisect.bisect_right(ends, s)       # first gap ending after s
        while i < len(gaps) and gaps[i][0] < e:
            gs, ge = gaps[i]
            key = (min(e, ge) - max(s, gs), -(e - s), name)
            if best[i] is None or key[:2] > best[i][:2]:
                best[i] = key
            i += 1
    out: Dict[str, float] = {}
    for (gs, ge), b in zip(gaps, best):
        name = "host (no op)" if b is None else b[2]
        out[name] = out.get(name, 0.0) + (ge - gs) / 1e9
    return out


class DeviceTrace:
    """What the profiler saw of the device over the window."""

    def __init__(self, kernels: List[Tuple[str, int, int]],
                 host_ops: List[Tuple[str, int, int]], window_s: float):
        self.kernels = kernels
        self.host_ops = host_ops
        self.window_s = window_s
        self.busy = union_ns((s, e) for _, s, e in kernels)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def kernel_seconds(self, parts: Sequence[str]) -> float:
        """Device seconds of the activities whose name contains any of
        ``parts``."""
        return sum(e - s for n, s, e in self.kernels
                   if any(p in n for p in parts)) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = {}
        for n, s, e in self.kernels:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
        idle = label_gaps(gaps_ns(self.busy), self.host_ops)

        def head(d):
            return [[k[:200], v] for k, v in sorted(
                d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": head(by_name), "idle_gaps": head(idle)}


class Window:
    """The measured window: ``open()`` synchronises the device and starts
    the clock, ``close()`` synchronises and stops it. With ``traced`` a
    ``torch.profiler`` runs from just before ``open`` to just after
    ``close``; ``trace`` then holds what it recorded."""

    def __init__(self, device, traced: bool):
        self.device = device
        self.traced = traced
        self.trace: Optional[DeviceTrace] = None
        self.t0 = self.t1 = None
        self._prof = None

    def open(self) -> float:
        if self.traced:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
        sync(self.device)
        self.t0 = time.perf_counter()
        return self.t0

    def close(self) -> float:
        sync(self.device)
        self.t1 = time.perf_counter()
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            self.trace = read_profile(self._prof, self.t1 - self.t0)
            self._prof = None
        return self.t1

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def read_profile(prof, window_s: float) -> DeviceTrace:
    """Device activities and host ops from a stopped profiler, in memory."""
    from torch._C._autograd import DeviceType
    kernels, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            kernels.append((ev.name(), s, e))
        elif e > s:
            host.append((ev.name(), s, e))
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity in the "
                           "window; no device metric can be read")
    return DeviceTrace(kernels, host, window_s)
