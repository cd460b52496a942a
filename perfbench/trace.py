"""Host spans and the device trace of a bounded slice.

``Spans`` times calls into the program's layers from outside: a wrapper put
around a module function at run time synchronizes the card before and after
each call, so a span is the wall time of the call's device work.  Used only
in ``--trace 1`` runs; ``--trace 0`` runs take the end-to-end metrics
without it.

``profile(fn)`` runs ``fn`` under ``torch.profiler`` and keeps only what the
metrics read: each device interval (kernels, copies, sets) with its name,
the host's operations (for what the host did while the card idled), and the
slice's wall time.  No Chrome trace is written.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from typing import Callable

import torch


class Spans:
    """Seconds and units summed per span name."""

    def __init__(self, device: torch.device, on: bool):
        self.device, self.on = device, on
        self.seconds: dict[str, float] = {}
        self.units: dict[str, float] = {}

    def add(self, name: str, seconds: float, units: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds
        self.units[name] = self.units.get(name, 0.0) + units

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def wrap(self, module, attr: str, name: str, units: Callable):
        """While inside, ``module.attr`` is timed as span ``name``;
        ``units(args, kwargs, result)`` counts its work (steps, audio
        seconds).  Off: the function runs as it is."""
        real = getattr(module, attr)

        def timed(*args, **kwargs):
            if not self.on:
                return real(*args, **kwargs)
            self._sync()
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            self._sync()
            self.add(name, time.perf_counter() - t0, units(args, kwargs, out))
            return out

        setattr(module, attr, timed)
        try:
            yield
        finally:
            setattr(module, attr, real)

    def facts(self) -> dict:
        return {name: {"seconds": s, "units": self.units[name]} for name, s in self.seconds.items()}


@dataclasses.dataclass
class Trace:
    window_s: float
    device: list[tuple[float, float, str]]  # (start_us, end_us, name), sorted by start
    host: list[tuple[float, float, str]]  # host operations, sorted by start

    def merged(self) -> list[tuple[float, float]]:
        out: list[list[float]] = []
        for s, e, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) / 1e6

    def idle_share(self) -> float | None:
        """Percent of the slice in which no device operation ran."""
        if self.window_s <= 0 or not self.device:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def kernel_seconds(self, names: list[str]) -> float:
        """Device seconds of the operations whose name contains one of
        ``names``."""
        return sum(e - s for s, e, n in self.device if any(k in n for k in names)) / 1e6

    def top_ops(self, n: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for s, e, name in self.device:
            by[name[:120]] = by.get(name[:120], 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """Idle seconds between device operations, summed by the innermost
        host operation running at each gap's middle."""
        merged = self.merged()
        gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
        gaps.sort(key=lambda g: g[0] - g[1])
        starts = [h[0] for h in self.host]
        by: dict[str, float] = {}
        for s, e in gaps[:2000]:
            mid = (s + e) / 2
            i = bisect.bisect_right(starts, mid)
            best = None
            for hs, he, name in reversed(self.host[max(0, i - 200):i]):
                if he >= mid and (best is None or he - hs < best[1] - best[0]):
                    best = (hs, he, name)
            label = best[2] if best else "(no host operation)"
            by[label] = by.get(label, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}


def profile(fn: Callable[[], object], device: torch.device) -> Trace:
    """``fn`` once under the profiler, the card synchronized before and
    after; the trace of that slice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize(device)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue
        r = (e.time_range.start, e.time_range.end, e.name)
        (dev if e.device_type == DeviceType.CUDA else host).append(r)
    dev.sort()
    host.sort()
    return Trace(window, dev, host)
