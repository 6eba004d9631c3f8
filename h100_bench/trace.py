"""The traced window: every operation the device ran, from torch.profiler's
CUDA activity (CUPTI), and the harness's own host spans beside them.

Only device activity is recorded (kernels, copies, memsets): no host op
table, so a window of hundreds of thousands of kernels stays cheap to
record and to read. The readers here reduce it to what the per-layer
metrics and the result's `breakdown` need: the device time of kernels by
name pattern, the busy time (the union of the device's intervals), and
the longest idle gaps named by the host span they fall in.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, List, Sequence, Tuple

import torch

Kernel = Tuple[str, int, int]  # name, start ns, duration ns


@dataclasses.dataclass
class Span:
    """A host span of the harness: label, start and end (time.time_ns)."""

    label: str
    start_ns: int
    end_ns: int


class Spans:
    """Host spans around each call the window makes into the program."""

    def __init__(self):
        self.items: List[Span] = []

    def add(self, label: str, start_ns: int, end_ns: int) -> None:
        self.items.append(Span(label, start_ns, end_ns))

    @staticmethod
    def now() -> int:
        return time.time_ns()


def _ns(event, what: str) -> int:
    fn = getattr(event, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(event, f"{what}_us")() * 1000)


class Tracer:
    """Context manager: records the card's activity while open. After it
    closes, `kernels` holds (name, start ns, duration ns) of every device
    operation, sorted by start. On the CPU (the tests) it records nothing."""

    def __init__(self, device: torch.device):
        self.kernels: List[Kernel] = []
        self._prof = None
        self._on = device.type == "cuda"

    def __enter__(self):
        if self._on:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        results = self._prof.profiler.kineto_results
        cuda = torch.autograd.DeviceType.CUDA
        out = []
        for e in results.events():
            if e.device_type() != cuda:
                continue
            dur = _ns(e, "duration")
            if dur <= 0:
                continue
            out.append((e.name(), _ns(e, "start"), dur))
        out.sort(key=lambda k: k[1])
        self.kernels = out
        self._prof = None
        return False


def matches(name: str, patterns: Sequence[str], exclude: Sequence[str] = ()) -> bool:
    return any(p in name for p in patterns) and not any(x in name for x in exclude)


def device_ns(kernels: Iterable[Kernel], patterns: Sequence[str],
              exclude: Sequence[str] = ()) -> int:
    """Summed device time of the operations whose name holds a pattern."""
    return sum(d for n, _, d in kernels if matches(n, patterns, exclude))


def busy_ns(kernels: Sequence[Kernel]) -> int:
    """Length of the union of the device's intervals."""
    total, end = 0, None
    for _, s, d in kernels:
        e = s + d
        if end is None or s >= end:
            total += d
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def top_ops(kernels: Sequence[Kernel], n: int = 10) -> List[list]:
    """The n device operations that took most time, [name, seconds]."""
    by: dict = {}
    for name, _, d in kernels:
        by[name] = by.get(name, 0) + d
    ranked = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[_short(name), ns / 1e9] for name, ns in ranked]


def _short(name: str, limit: int = 160) -> str:
    return name if len(name) <= limit else name[: limit - 3] + "..."


def idle_gaps(kernels: Sequence[Kernel], spans: Sequence[Span], n: int = 10) -> List[list]:
    """The n longest idle stretches between device operations, each named
    by the host span it starts in and the operation before it. The host
    and device clocks are aligned on the first span's start and the first
    operation's start."""
    if not kernels:
        return []
    offset = kernels[0][1] - spans[0].start_ns if spans else 0
    gaps = []
    end, prev = None, None
    for name, s, d in kernels:
        if end is not None and s > end:
            gaps.append((s - end, end, prev))
        if end is None or s + d > end:
            end, prev = s + d, name
    gaps.sort(key=lambda g: -g[0])
    out = []
    for length, at, before in gaps[:n]:
        host = _span_at(spans, at - offset)
        out.append([f"{host}; after {_short(before, 100)}", length / 1e9])
    return out


def _span_at(spans: Sequence[Span], t: int) -> str:
    for sp in spans:
        if sp.start_ns <= t <= sp.end_ns:
            return f"host in {sp.label}"
    return "host in the harness, between calls"
