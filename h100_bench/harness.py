"""One run of one cell: set-up, the measured window, the check of what the
window produced, and the result line.

The driver named by the cell's traffic file (drivers/<driver>.py) builds a
Session: the program's entry point, the inputs made from the seed, every
shape the window uses warmed up. The harness times the set-up, resets the
device's peak memory, runs the window (under the profiler with --trace 1),
reads the peak, has the session free the program, and only then has it
run the plain reference over what the window produced. The metrics' own
files turn the record of the window (`Run`) into numbers.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
from typing import Dict, List, Optional

import torch

from h100_bench import card, registry, trace


@dataclasses.dataclass
class Check:
    """One number compared with the plain reference, and its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    """What the metrics read: the cell, the window and, when traced, the
    device's operations and the harness's host spans."""

    cell: registry.Cell
    setup_s: float
    window_s: float
    attempted: int
    latencies_ms: List[float]
    peak_bytes: int
    input_bytes: int
    held_bytes: int
    info: Dict[str, object]
    spans: trace.Spans
    kernels: Optional[List[trace.Kernel]] = None

    @property
    def model(self) -> dict:
        return self.cell.config["model"]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(bench: registry.Bench, name: str, seed: int, seconds: float, traced: bool,
             device: torch.device, t0: float, session_wrap=None) -> dict:
    """The result of one run, as a dict in the result line's key order.
    `session_wrap`, for tests, replaces the session before its window."""
    cell = bench.cell(name)
    drv = registry.driver(cell.traffic["driver"], cell.root)
    t_session = time.perf_counter()
    session = drv.Session(cell, seed, device)
    if session_wrap is not None:
        session = session_wrap(session)
    cuda = device.type == "cuda"
    _sync(device)
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    print("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                 {"to the session": t_session - t0, **session.phases}.items()),
          file=sys.stderr, flush=True)
    spans = trace.Spans()
    tracer = trace.Tracer(device) if traced else None
    if tracer is not None:
        with tracer:
            rec = session.window(seconds, spans)
    else:
        rec = session.window(seconds, spans)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run = Run(cell=cell, setup_s=setup_s, window_s=rec["window_s"],
              attempted=rec["attempted"], latencies_ms=rec.get("latencies_ms", []),
              peak_bytes=peak, input_bytes=session.input_bytes,
              held_bytes=session.held_bytes(), info=session.info(), spans=spans,
              kernels=tracer.kernels if tracer else None)
    session.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks: List[Check] = [Check(n, v, lim) for n, v, lim in session.check()]
    failed = sum(not c.ok for c in checks)
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = registry.metric(m["name"], cell.root).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips if cuda else 1,
           "memory_peak_bytes": max(setup_peak, peak)}
    if cuda:
        dev["power_limit_w"] = card.power_limit_w(device)
    result = {"correct": bool(checks) and failed == 0, "attempted": rec["attempted"],
              "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        kernels = run.kernels or []
        dev["busy_s"] = trace.busy_ns(kernels) / 1e9
        dev["window_s"] = run.window_s
        result["breakdown"] = {"device_ops": trace.top_ops(kernels),
                               "idle_gaps": trace.idle_gaps(kernels, spans.items)}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result


def print_checks(result: dict, stream=sys.stderr) -> None:
    """The numbers compared, each beside its limit: the run's last lines on
    standard error."""
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} {verdict}", file=stream)
    print(f"correct = {result['correct']}", file=stream, flush=True)
