"""The metric arithmetic: a rate over the whole window, the p95 over every
frame, the device's busy and idle share and the time by kernel name from a
synthetic trace, the roofline shares and the memory less the inputs."""

import pytest

from h100_bench import harness, readers, registry, trace
from h100_bench.tests.conftest import BENCH, REPO, TRAIN

CONV = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize256x64x32_kernel__5x_cudnn"
K1 = "void (anonymous namespace)::kpn_apply_kernel<5, 3, 8>(float const*, float const*, float*, int)"
ADD = "void at::native::elementwise_kernel<128, 4, at::native::CUDAFunctor_add<c10::BFloat16> >(int)"
# (name, start ns, duration ns): 3 frames of 10 ms, busy 6 + 2 + 1 ms each, the
# add overlapping the conv by 1 ms
KERNELS = [k for f in range(3) for k in (
    (CONV, f * 10_000_000, 6_000_000),
    (ADD, f * 10_000_000 + 5_000_000, 2_000_000),
    (K1, f * 10_000_000 + 8_000_000, 1_000_000),
)]


def _run(cell_name, kernels=None, bench=None, **kw):
    bench = bench or registry.load(REPO / "BENCHMARK.json", BENCH)
    cell = bench.cell(cell_name)
    spans = trace.Spans()
    for f in range(3):
        spans.add(f"frame call {f}", f * 10_000_000, f * 10_000_000 + 9_500_000)
    base = dict(cell=cell, setup_s=5.0, window_s=0.03, attempted=3,
                latencies_ms=[], peak_bytes=0, input_bytes=0, held_bytes=0,
                info={"infer": {**cell.config["infer"], **cell.workload.get("infer", {})}},
                spans=spans, kernels=kernels)
    base.update(kw)
    return harness.Run(**base)


def _metric(name, run):
    return registry.metric(name, BENCH).read(run)


def test_busy_is_the_union_of_the_device_intervals_and_idle_its_rest():
    assert trace.busy_ns(KERNELS) == 3 * 8_000_000
    run = _run("kpn-hq.1080p", KERNELS)
    assert _metric("device_idle_pct.frame", run) == pytest.approx(20.0)
    assert _metric("device_idle_pct.train", run) is None


def test_time_by_name_pattern():
    run = _run("kpn-hq.1080p", KERNELS)
    assert _metric("conv_ms.frame", run) == pytest.approx(6.0)
    assert _metric("elementwise_ms.frame", run) == pytest.approx(2.0)
    assert readers.device_ns(run, readers.K1) == 3_000_000
    assert readers.device_ns(_run("kpn-hq.1080p"), readers.K1) is None


def test_k1_roofline_counts_the_work_of_every_slot_over_the_kernels_time():
    run = _run("kpn-hq.1080p", KERNELS)
    bytes_ = 8 * 281_442_304  # 8 slots over the 1144 x 1984 plane
    assert _metric("k1_roofline", run) == pytest.approx(100 * bytes_ / 3.35e12 / 1e-3)
    assert _metric("group_encode_roofline", run) is None  # joint: no group encode


def test_a_metric_with_nothing_to_read_is_left_out():
    run = _run("kpn-hq.1080p", [(CONV, 0, 1000)])
    assert _metric("k1_roofline", run) is None


def test_whole_window_rate_and_p95_over_every_frame():
    lat = [10.0] * 95 + [50.0] * 5
    run = _run("kpn-hq.1080p", attempted=100, window_s=2.0, latencies_ms=lat)
    assert _metric("frames_per_s", run) == 50.0
    assert _metric("frame_ms_p95", run) == pytest.approx(48.0)
    assert _metric("frame_ms_p95", _run("kpn-hq.1080p", latencies_ms=[1.0] * 10)) is None
    assert _metric("train_samples_per_s", run) is None


def test_train_rate_and_mfu(small_bench):
    run = _run(TRAIN, kernels=[], bench=small_bench, attempted=10, window_s=1.0)
    assert _metric("train_samples_per_s", run) == 10 * run.cell.traffic["batch"]
    assert _metric("mfu.train", run) > 0
    assert _metric("mfu.frame", run) is None and _metric("frames_per_s", run) is None


def test_mfu_frame_counts_the_whole_plane_not_the_tiles():
    tiled = _run("kpn-hq.4k-tiled", KERNELS, attempted=1, window_s=1.0)
    whole = _run("kpn-hq.4k-tiled", KERNELS, attempted=1, window_s=1.0)
    whole.info["infer"] = {**whole.info["infer"], "tile": 0, "tile_batch": 0}
    assert _metric("mfu.frame", tiled) == pytest.approx(_metric("mfu.frame", whole))
    assert _metric("mfu.frame", tiled) == pytest.approx(100 * 15722.60192256e9 / 989e12, rel=1e-9)


def test_peak_memory_leaves_out_the_inputs_and_kept_outputs():
    run = _run("kpn-hq.1080p", peak_bytes=5 * 2**30, input_bytes=2**30, held_bytes=2**29)
    assert _metric("peak_mem_gib", run) == 3.5
    assert _metric("peak_mem_gib", _run("kpn-hq.1080p")) is None


def test_idle_gaps_are_named_by_the_host_span_and_the_operation_before():
    gaps = trace.idle_gaps(KERNELS, _run("kpn-hq.1080p").spans.items)
    # in each frame the device idles 1 ms after the add and 1 ms after K1
    assert len(gaps) == 5 and all(g[1] == pytest.approx(0.001) for g in gaps)
    assert all(g[0].startswith("host in frame call") for g in gaps)
    assert sum("kpn_apply_kernel" in g[0] for g in gaps) == 2
    assert sum("CUDAFunctor_add" in g[0] for g in gaps) == 3
    ops = trace.top_ops(KERNELS)
    assert ops[0] == [CONV, 0.018] and len(ops) == 3
