"""The program's own spans and counters, as the benchmark reads them, and
the attribution of every device operation to the span that launched it.

The program (deepdenoiser_tpu_torch/tracing.py) records spans at its
layer boundaries on the host clock, `time.time_ns()`, while its recorder is
on; `recording()` turns it on around a window and takes the spans. That
is the clock torch.profiler puts its events on: Kineto converts CUPTI's
times to Unix-epoch ns. `LaunchTracer` keeps what `trace.Tracer` drops,
the CUDA runtime and driver calls that launched each device operation
(`cudaLaunchKernel`, `cuLaunchKernel*`, `cudaMemcpyAsync`,
`cudaMemsetAsync`, ...), matched to the operation by CUPTI's correlation
id. An operation then belongs to the innermost program span whose host
interval holds its launch, with no offset fitted between the clocks, and
a layer's device time is its self time: the operations whose innermost
span is that layer. An operation with no launch event, or launched
outside every program span, is unattributed.

A Run carries what is read here as attributes: `program_spans` (a list of
ProgramSpan), `launches` (correlation id -> host ns) and `kernel_ids`
(each entry of `kernels`' correlation id). Where the run has none of them
(the harness does not record them), every reader returns None.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from h100_bench import trace

# the program's layers, by span name; `chunk` and `frame` hold no
# operation of their own on the frame path
LAYERS = ("encode", "net", "backbone", "head", "k1", "decode")


class ProgramSpan(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    frame: int
    start_ns: int
    end_ns: int


@contextlib.contextmanager
def recording(on: bool = True):
    """Turn the program's span recorder on for the block; the list it
    yields holds the spans once the block ends. A program without a
    recorder, or `on` false, records nothing."""
    got: List[ProgramSpan] = []
    try:
        from deepdenoiser_tpu_torch import tracing
    except ImportError:
        tracing = None
    if tracing is None or not on:
        yield got
        return
    tracing.enable()
    try:
        yield got
    finally:
        tracing.disable()
        got.extend(ProgramSpan(s.name, s.id, s.parent, s.frame, s.start_ns, s.end_ns)
                   for s in tracing.take())


class LaunchTracer(trace.Tracer):
    """trace.Tracer (its `kernels` unchanged) that also keeps the launch
    events: `launches` maps a correlation id to the host ns at which the
    runtime or driver call began (the earliest, where a runtime call and
    the driver call inside it share one), and `kernel_ids[i]` is the
    correlation id of `kernels[i]`."""

    def __init__(self, device: torch.device):
        super().__init__(device)
        self.launches: Dict[int, int] = {}
        self.kernel_ids: List[int] = []

    def __exit__(self, *exc):
        prof = self._prof
        super().__exit__(*exc)
        if prof is None or exc[0] is not None:
            return False
        cuda = torch.autograd.DeviceType.CUDA
        ops = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                if trace._ns(e, "duration") > 0:
                    ops.append((trace._ns(e, "start"), e.correlation_id()))
            elif e.name().startswith("cu"):
                c, t = e.correlation_id(), trace._ns(e, "start")
                if t < self.launches.get(c, t + 1):
                    self.launches[c] = t
        ops.sort(key=lambda o: o[0])  # the order trace.Tracer sorts `kernels` in
        assert len(ops) == len(self.kernels)
        self.kernel_ids = [c for _, c in ops]
        return False


def innermost(spans: Sequence, times: Sequence[Optional[int]]) -> list:
    """For each host time, the innermost of `spans` (nested intervals with
    start_ns and end_ns, ends included) that holds it, or None; a None
    time gets None."""
    order = sorted((t, i) for i, t in enumerate(times) if t is not None)
    ranked = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
    out: list = [None] * len(times)
    stack: list = []
    j = 0
    for t, i in order:
        while j < len(ranked) and ranked[j].start_ns <= t:
            while stack and stack[-1].end_ns < ranked[j].start_ns:
                stack.pop()
            stack.append(ranked[j])
            j += 1
        while stack and stack[-1].end_ns < t:
            stack.pop()
        out[i] = stack[-1] if stack else None
    return out


def _launch_ns(run) -> Optional[List[Optional[int]]]:
    launches, ids = getattr(run, "launches", None), getattr(run, "kernel_ids", None)
    if run.kernels is None or launches is None or ids is None:
        return None
    return [launches.get(c) for c in ids]


def _owners(run) -> Optional[list]:
    """Each operation's innermost program span, or None; cached on the run."""
    cached = run.__dict__.get("_span_owners")
    if cached is None:
        t = _launch_ns(run)
        spans = getattr(run, "program_spans", None)
        if t is None or not spans:
            return None
        cached = run.__dict__["_span_owners"] = innermost(spans, t)
    return cached


def self_ns(run) -> Optional[Dict[Optional[str], int]]:
    """Device ns by the name of each operation's innermost program span;
    the key None holds the unattributed operations."""
    owners = _owners(run)
    if owners is None:
        return None
    out: Dict[Optional[str], int] = {}
    for (_, _, d), s in zip(run.kernels, owners):
        key = s.name if s is not None else None
        out[key] = out.get(key, 0) + d
    return out


def layer_ms(run, name: str) -> Optional[float]:
    """Device ms a frame of the operations whose innermost span is `name`."""
    by = self_ns(run)
    if by is None or not run.attempted:
        return None
    return by.get(name, 0) / 1e6 / run.attempted


def dispatch_ms(run) -> Optional[float]:
    """Host ms a `frame` span lasts, on average."""
    frames = [s for s in getattr(run, "program_spans", None) or () if s.name == "frame"]
    if not frames:
        return None
    return sum(s.end_ns - s.start_ns for s in frames) / 1e6 / len(frames)


def per_frame_count(run, module: str, name: str) -> Optional[float]:
    """A plain count of the program's, `module.name`, over every frame the
    run's process denoised (the traffic's warm-up frames and the window's):
    the count is the program's since the process began. None where the
    program is not loaded or has no such count."""
    count = getattr(sys.modules.get(module), name, None)
    frames = run.cell.traffic.get("warm", 0) + run.attempted
    if not isinstance(count, int) or not frames:
        return None
    return count / frames


def launches_outside(run, patterns: Sequence[str], span: str) -> Optional[tuple]:
    """(operations whose name holds a pattern, those of them whose launch
    is not inside a `span` span): the shared clock's check."""
    owners = _owners(run)
    if owners is None:
        return None
    mine = [s for (n, _, _), s in zip(run.kernels, owners) if trace.matches(n, patterns)]
    return len(mine), sum(s is None or s.name != span for s in mine)


def gaps(kernels: Sequence[trace.Kernel], n: int = 10) -> List[tuple]:
    """The n longest idle stretches between device operations, as
    (length ns, start ns, index of the operation after it), longest first:
    the stretches and order of trace.idle_gaps."""
    found = []
    end = None
    for i, (_, s, d) in enumerate(kernels):
        if end is not None and s > end:
            found.append((s - end, end, i))
        if end is None or s + d > end:
            end = s + d
    found.sort(key=lambda g: -g[0])
    return found[:n]


def _where(program, harness, what: str) -> str:
    if program is not None:
        return f"{what} {program.name} (frame {program.frame})"
    if harness is not None:
        return f"{what} {harness.label}"
    return f"{what} the harness, between calls"


def idle_gaps(run, n: int = 10) -> Optional[List[list]]:
    """trace.idle_gaps's stretches, each named by the innermost span (the
    program's, else the harness's) the host was in when it began and the
    span that launched the operation after it, on the one clock:
    [name, seconds]."""
    if run.kernels is None:
        return None
    top = gaps(run.kernels, n)
    launch = _launch_ns(run)
    nxt = [launch[i] if launch else None for _, _, i in top]
    prog = getattr(run, "program_spans", None) or []
    at = [a for _, a, _ in top]
    host_p, host_h = innermost(prog, at), innermost(run.spans.items, at)
    next_p, next_h = innermost(prog, nxt), innermost(run.spans.items, nxt)
    out = []
    for k, (length, _, _) in enumerate(top):
        name = _where(host_p[k], host_h[k], "host in")
        if nxt[k] is None:
            name += "; next launch not recorded"
        else:
            name += "; " + _where(next_p[k], next_h[k], "next launched in")
        out.append([name, length / 1e9])
    return out
