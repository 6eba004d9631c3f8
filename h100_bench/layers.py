"""A frame cell's traced window with the program's span recorder on, and
its device time split by the program's layers.

    python3 -m h100_bench.layers --workload <cell> --seed <n> --seconds <s> [--recorder 0|1]

from the root of a checkout, on the card. The harness's own run of the
cell (harness.run_cell: set-up, window, the check that decides `correct`)
with its window under spans.LaunchTracer, which keeps the launch events,
and the program's recorder on around it (off with --recorder 0, to cost
the recorder). From that one window it reads every per-layer metric the
cell reports in BENCHMARK.json, the span metrics of `LAYER_METRICS`, the
attribution's totals and the clock's check, and prints them as one JSON
line on standard output; standard error gets the same in lines. The
harness's `--trace 1` run does not record launch events or program spans,
so the metrics of `LAYER_METRICS` are read here only.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

LAYER_METRICS = ("encode_ms.frame", "plane_ms.frame", "backbone_ms.frame", "head_ms.frame",
                 "decode_ms.frame", "dispatch_ms.frame")
# the hand-written kernels and the span each must be launched in
CLOCK_CHECKS = {"k1": ("kpn_apply_kernel",), "encode": ("group_encode_kernel",)}


class _Recorded:
    """The driver's session, its window run under the LaunchTracer with the
    program's recorder on; keeps what the window recorded."""

    def __init__(self, session, device, recorder: bool):
        self._session, self._device, self._recorder = session, device, recorder

    def __getattr__(self, name):
        return getattr(self._session, name)

    def window(self, seconds, hspans):
        from h100_bench import spans

        self.tracer = spans.LaunchTracer(self._device)
        with spans.recording(self._recorder) as got, self.tracer:
            self.rec = self._session.window(seconds, hspans)
        self.hspans, self.program_spans = hspans, got
        self.window_info = self._session.info()
        return self.rec


def split(run) -> dict:
    """The attribution's totals, ms a frame: each span's self time, the
    unattributed time, the busy time, their sum over the layers."""
    from h100_bench import readers, spans, trace

    by = spans.self_ns(run) or {}
    frames = run.attempted or 1
    ms = {("unattributed" if k is None else k): v / 1e6 / frames for k, v in by.items()}
    busy = trace.busy_ns(run.kernels or []) / 1e6 / frames
    layers = sum(ms.get(k, 0.0) for k in spans.LAYERS)
    k1 = (readers.device_ns(run, readers.K1) or 0) / 1e6 / frames
    return {"self_ms": ms, "busy_ms": busy, "layers_ms": layers,
            "layers_over_busy": layers / busy if busy else None,
            "unattributed_pct": 100 * ms.get("unattributed", 0.0) / busy if busy else None,
            "k1_kernel_ms": k1,
            "launch_matched_pct": _matched_pct(run)}


def _matched_pct(run):
    launch = run.launches or {}
    ids = run.kernel_ids or []
    return 100 * sum(c in launch for c in ids) / len(ids) if ids else None


def window_run(bench, name: str, seed: int, seconds: float, device, recorder: bool = True,
               t0: float = 0.0):
    """(the harness's result of the cell's untraced run, the Run of its
    window with the spans, launch events and correlation ids attached)."""
    from h100_bench import harness

    box = {}

    def wrap(session):
        box["s"] = _Recorded(session, device, recorder)
        return box["s"]

    result = harness.run_cell(bench, name, seed, seconds, False, device, t0, session_wrap=wrap)
    s = box["s"]
    run = harness.Run(cell=bench.cell(name), setup_s=result["metrics"]["setup_s"]["value"],
                      window_s=s.rec["window_s"], attempted=s.rec["attempted"],
                      latencies_ms=s.rec.get("latencies_ms", []), peak_bytes=0, input_bytes=0,
                      held_bytes=0, info=s.window_info, spans=s.hspans, kernels=s.tracer.kernels)
    run.program_spans, run.launches, run.kernel_ids = (s.program_spans, s.tracer.launches,
                                                      s.tracer.kernel_ids)
    return result, run


def run_layers(bench, name: str, seed: int, seconds: float, device, recorder: bool = True,
               t0: float = 0.0) -> dict:
    from h100_bench import registry, spans, trace

    result, run = window_run(bench, name, seed, seconds, device, recorder, t0)
    cell = run.cell
    names = [m["name"] for m in cell.per_layer] + [m for m in LAYER_METRICS
                                                   if m not in {x["name"] for x in cell.per_layer}]
    per_layer = {m: registry.metric(m, cell.root).read(run) for m in names}
    clock = {}
    for span, patterns in CLOCK_CHECKS.items():
        got = spans.launches_outside(run, patterns, span)
        if got is not None and got[0]:
            clock[patterns[0]] = {"launches": got[0], "outside_" + span: got[1]}
    return {"workload": name, "seed": seed, "recorder": recorder, "correct": result["correct"],
            "attempted": run.attempted, "frames_per_s": run.attempted / run.window_s,
            "end_to_end": {k: v["value"] for k, v in result["metrics"].items()},
            "per_layer": per_layer, "split": split(run), "clock": clock,
            "program_spans": len(run.program_spans),
            "idle_gaps": spans.idle_gaps(run),
            "idle_gaps_harness": trace.idle_gaps(run.kernels, run.spans.items),
            "checks": result["checks"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--recorder", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)

    import torch

    from h100_bench import registry

    bench = registry.load()
    cell = bench.cell(args.workload)
    if cell.traffic["driver"] != "frames" or not torch.cuda.is_available():
        print("h100_bench.layers: a frame cell on a CUDA card only", file=sys.stderr)
        return 2
    out = run_layers(bench, args.workload, args.seed, args.seconds, torch.device("cuda", 0),
                     bool(args.recorder), T0)
    for key in ("per_layer", "split", "clock"):
        for k, v in out[key].items():
            print(f"{args.workload} seed {args.seed} {key} {k} = {v!r}", file=sys.stderr)
    for name, s in out["idle_gaps"] or ():
        print(f"{args.workload} gap {s * 1e3:.3f} ms: {name}", file=sys.stderr)
    print(f"correct = {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
