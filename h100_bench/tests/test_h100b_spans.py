"""The attribution of device operations to the program's spans, on
synthetic kernels, launch events and spans: the innermost span takes an
operation, a layer's time is its self time, an operation with no launch
event or launched outside every span is unattributed, the idle gaps are
named on the one clock with the stretches and order of trace.idle_gaps,
and every existing metric reads the same with the spans attached. Then the
launch tracer on a fake profiler, and the layer runner on the CPU."""

import sys
import types

import pytest
import torch

from h100_bench import harness, layers, registry, spans, trace
from h100_bench.tests.conftest import BENCH, REPO
from h100_bench.tests.test_h100b_metrics import KERNELS, _run

CONV = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_kernel__5x_cudnn"
K1 = "void (anonymous namespace)::kpn_apply_kernel<5, 3, 8>(float const*, float const*, float*, int)"
ADD = "void at::native::elementwise_kernel<128, 4, at::native::CUDAFunctor_add<float> >(int)"
ENC = "void group_encode_kernel(...)"
MS = 1_000_000


def _frame_spans(f, t0):
    """One frame's spans from host time t0 (ms steps), ids from 10 * f."""
    i = 10 * f

    def sp(k, name, parent, a, b):
        return spans.ProgramSpan(name, i + k, None if parent is None else i + parent, f,
                                 t0 + a * MS, t0 + b * MS)

    return [sp(0, "frame", None, 0, 10), sp(1, "encode", 0, 0.5, 1.5), sp(2, "net", 0, 1.5, 8),
            sp(3, "chunk", 2, 2, 7.5), sp(4, "backbone", 3, 2, 5), sp(5, "head", 3, 5, 7.5),
            sp(6, "k1", 5, 6, 6.5), sp(7, "decode", 0, 8, 9.5)]


# (name, device start ms, device ms, launch ms) a frame: the device runs
# behind the host's launches
OPS = [(ENC, 3, 0.5, 1.0), (ADD, 4, 0.25, 1.8), (CONV, 4.5, 2, 3), (ADD, 6.5, 0.5, 4),
       (ADD, 7, 1, 5.5), (K1, 8, 0.5, 6.2), (ADD, 8.5, 0.25, 7), (ADD, 9, 0.25, 7.8),
       (ADD, 10, 1, 9)]


def _synthetic(frames=2, unmatched=(), outside=()):
    """A run of `frames` frames of 20 ms: OPS a frame; the operations at
    the (frame, index) pairs of `unmatched` have no launch event, those of
    `outside` are launched after the frame's spans closed."""
    kernels, ids, launches, prog = [], [], {}, []
    for f in range(frames):
        base = f * 20 * MS
        prog += _frame_spans(f, base)
        for j, (name, start, dur, at) in enumerate(OPS):
            c = 1000 * f + j
            kernels.append((name, base + int(start * MS), int(dur * MS)))
            ids.append(c)
            if (f, j) not in unmatched:
                launches[c] = base + int((10.5 if (f, j) in outside else at) * MS)
    run = _run("flagship-max.1080p", kernels, attempted=frames, window_s=frames * 0.02)
    run.program_spans, run.launches, run.kernel_ids = prog, launches, ids
    return run


def test_innermost_takes_the_deepest_span_holding_each_time():
    prog = _frame_spans(0, 0)
    got = spans.innermost(prog, [int(t * MS) for t in (0.2, 1, 1.6, 3, 6.2, 7.9, 9, 12)] + [None])
    assert [s and s.name for s in got] == ["frame", "encode", "net", "backbone", "k1", "net",
                                           "decode", None, None]


def test_each_operation_goes_to_its_innermost_span_and_a_layer_reads_its_self_time():
    run = _synthetic()
    want = {"encode": 0.5, "net": 0.25 + 0.25, "backbone": 2 + 0.5, "head": 1 + 0.25,
            "k1": 0.5, "decode": 1.0}
    for name, ms in want.items():
        assert spans.layer_ms(run, name) == pytest.approx(ms)
    assert spans.self_ns(run).get(None, 0) == 0
    assert registry.metric("encode_ms.frame", BENCH).read(run) == pytest.approx(0.5)
    assert registry.metric("plane_ms.frame", BENCH).read(run) == pytest.approx(0.5)
    assert registry.metric("backbone_ms.frame", BENCH).read(run) == pytest.approx(2.5)
    assert registry.metric("head_ms.frame", BENCH).read(run) == pytest.approx(1.25)  # no K1
    assert registry.metric("decode_ms.frame", BENCH).read(run) == pytest.approx(1.0)
    assert registry.metric("dispatch_ms.frame", BENCH).read(run) == pytest.approx(10.0)
    assert sum(spans.self_ns(run).values()) == sum(d for _, _, d in run.kernels)
    assert spans.launches_outside(run, layers.CLOCK_CHECKS["k1"], "k1") == (2, 0)
    assert spans.launches_outside(run, layers.CLOCK_CHECKS["encode"], "encode") == (2, 0)


def test_an_operation_with_no_launch_or_launched_outside_every_span_is_unattributed():
    run = _synthetic(unmatched={(0, 2)}, outside={(1, 5)})
    by = spans.self_ns(run)
    assert by[None] == 2 * MS + MS // 2
    assert spans.layer_ms(run, "backbone") == pytest.approx((2.5 + 0.5) / 2)
    assert spans.layer_ms(run, "k1") == pytest.approx(0.25)
    assert spans.launches_outside(run, layers.CLOCK_CHECKS["k1"], "k1") == (2, 1)
    split = layers.split(run)
    assert split["self_ms"]["unattributed"] == pytest.approx(1.25)
    assert split["launch_matched_pct"] == pytest.approx(100 * 17 / 18)


def test_without_program_spans_or_launch_events_the_span_readers_read_nothing():
    plain = _run("kpn-hq.1080p", KERNELS)
    for name in layers.LAYER_METRICS:
        assert registry.metric(name, BENCH).read(plain) is None
    no_launches = _synthetic()
    no_launches.launches = None
    assert spans.layer_ms(no_launches, "encode") is None
    assert spans.dispatch_ms(no_launches) == pytest.approx(10.0)


def test_gaps_are_named_on_the_one_clock_with_the_old_stretches_and_order():
    run = _synthetic()
    old = trace.idle_gaps(run.kernels, run.spans.items)
    new = spans.idle_gaps(run)
    assert [g[1] for g in new] == [g[1] for g in old]
    assert new[0][1] == pytest.approx(0.012)
    assert [g[0] for g in new] == [
        "host in frame call 1; next launched in encode (frame 1)",  # 11 ms, between frames
        "host in decode (frame 0); next launched in decode (frame 0)",
        "host in decode (frame 1); next launched in decode (frame 1)",
        "host in backbone (frame 0); next launched in net (frame 0)",
        "host in backbone (frame 1); next launched in net (frame 1)",
        "host in backbone (frame 0); next launched in backbone (frame 0)",
        "host in decode (frame 0); next launched in net (frame 0)",
        "host in backbone (frame 1); next launched in backbone (frame 1)",
        "host in decode (frame 1); next launched in net (frame 1)",
    ]


def test_gaps_fall_back_to_the_harness_spans_and_say_when_no_launch_was_recorded():
    run = _run("kpn-hq.1080p", KERNELS)
    names = [g[0] for g in spans.idle_gaps(run)]
    assert len(names) == 5
    assert all(n.startswith("host in frame call") and n.endswith("next launch not recorded")
               for n in names)
    assert [g[1] for g in spans.idle_gaps(run)] == [g[1] for g in trace.idle_gaps(KERNELS, run.spans.items)]


def test_every_existing_metric_reads_the_same_with_the_spans_attached():
    plain = _synthetic()
    bare = harness.Run(**{k: getattr(plain, k) for k in harness.Run.__dataclass_fields__})
    bench = registry.load(REPO / "BENCHMARK.json", BENCH)
    for cell in ("kpn-hq.1080p", "flagship-max.1080p", "kpn-hq.4k-tiled"):
        bare.cell = plain.cell = bench.cell(cell)
        for m in plain.cell.per_layer + plain.cell.end_to_end:
            read = registry.metric(m["name"], BENCH).read
            assert read(plain) == read(bare), m["name"]


def test_counts_a_frame_read_the_programs_counter_over_every_frame(monkeypatch):
    run = _run("kpn-hq.1080p", KERNELS, attempted=7)  # warm 3 + 7 frames
    fake = types.ModuleType("fake")
    monkeypatch.setitem(sys.modules, "deepdenoiser_tpu_torch.ops.kpn_apply", fake)
    assert registry.metric("k1_launches.frame", BENCH).read(run) is None
    fake.launches = 80
    assert registry.metric("k1_launches.frame", BENCH).read(run) == 8.0
    monkeypatch.delitem(sys.modules, "deepdenoiser_tpu_torch.inference.tiled", raising=False)
    assert registry.metric("net_calls.frame", BENCH).read(run) is None


class _Event:
    def __init__(self, name, cuda, start, dur, corr):
        self._v = (name, cuda, start, dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[1] else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def test_the_launch_tracer_keeps_launch_events_and_each_operations_correlation_id():
    events = [_Event(ADD, True, 500, 10, 7), _Event("cudaLaunchKernel", False, 100, 5, 7),
              _Event(CONV, True, 300, 20, 8), _Event("cuLaunchKernelEx", False, 90, 3, 8),
              _Event("cudaLaunchKernel", False, 80, 9, 8), _Event("Activity Buffer Request", False, 1, 1, 9),
              _Event("cudaMemsetAsync", False, 200, 2, 9), _Event("Memset (Device)", True, 400, 0, 9)]
    results = types.SimpleNamespace(events=lambda: events)
    tracer = spans.LaunchTracer(torch.device("cpu"))
    tracer._prof = types.SimpleNamespace(
        __exit__=lambda *a: None, profiler=types.SimpleNamespace(kineto_results=results))
    tracer.__exit__(None, None, None)
    assert tracer.kernels == [(CONV, 300, 20), (ADD, 500, 10)]
    assert tracer.kernel_ids == [8, 7]
    assert tracer.launches == {7: 100, 8: 80, 9: 200}


def test_the_layer_runner_reads_the_spans_and_counts_of_one_window(small_bench):
    from deepdenoiser_tpu_torch import tracing
    from deepdenoiser_tpu_torch.inference import tiled

    tiled.reset_net_calls()
    out = layers.run_layers(small_bench, "kpn-hq.4k-tiled", 5, 0.2, torch.device("cpu"))
    assert out["correct"] and out["attempted"] >= 1
    # 72 x 104 frames in tiles of 32: 3 x 4 tiles, chunks of 2
    assert out["per_layer"]["net_calls.frame"] == 6.0
    assert out["per_layer"]["k1_launches.frame"] == 0.0  # the plain filter apply on the CPU
    assert out["per_layer"]["dispatch_ms.frame"] > 0
    assert out["program_spans"] == out["attempted"] * (4 + 6 * (3 + 8))
    assert not tracing._on and tracing.take() == []
    off = layers.run_layers(small_bench, "kpn-hq.1080p", 5, 0.1, torch.device("cpu"), recorder=False)
    assert off["program_spans"] == 0 and off["per_layer"]["dispatch_ms.frame"] is None
