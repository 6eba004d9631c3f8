"""Arithmetic the metric files share: counts of the cell's frame and step
from the frozen counter (counts.py), device time by kernel name from the
trace, and the statistics of the window. Each metric file states the
names it reads; this module holds no metric of its own."""

from __future__ import annotations

import statistics
from typing import Optional, Sequence

from h100_bench import counts, registry, trace

# device kernels of the program's hand-written CUDA, by their __global__ names
K1 = ("kpn_apply_kernel",)
K1_BWD_WEIGHTS = ("kpn_bwd_weights_kernel",)
GROUP_ENCODE = ("group_encode_kernel",)


def arch(run):
    """The cell's reference module (its configuration's bench.reference):
    the architecture's halo, plane multiple and counted backbone."""
    return registry.reference(run.cell.config["bench"]["reference"], run.cell.root)


def certified_halo(run) -> int:
    return arch(run).halo(run.model)


def frame_hw(run):
    return run.cell.traffic["height"], run.cell.traffic["width"]


def whole_frame_flops(run) -> int:
    """FLOPs of one frame counted over the whole padded plane at the cell's
    size (tile 0): the work the frame needs, no tile's halo recomputed."""
    infer = {**run.info["infer"], "tile": 0, "tile_batch": 0}
    h, w = frame_hw(run)
    a = arch(run)
    rows = counts.count_frame(run.model, infer, h, w, a.halo(run.model), arch=a)
    return counts.totals(rows)["flops"]


def plan(run) -> counts.Grid:
    """The cell's frame plan, at the multiple of the cell's architecture."""
    h, w = frame_hw(run)
    a = arch(run)
    return counts.plan(run.model, run.info["infer"], h, w, a.halo(run.model), a)


def net_batch(run):
    """(N, h, w): the tiles (or planes) a frame's network runs over, with
    the last chunk filled to tile_batch as the program runs it."""
    infer = run.info["infer"]
    grid = plan(run)
    g = 4 if counts.mode(run.model) == "group" else 1
    n = g * grid.n_tiles
    tb = infer["tile_batch"]
    if grid.n_tiles > 1 and tb and tb < n:
        n = -(-n // tb) * tb
    return n, grid.net_h, grid.net_w


def device_ns(run, patterns: Sequence[str], exclude: Sequence[str] = ()) -> Optional[int]:
    if run.kernels is None:
        return None
    return trace.device_ns(run.kernels, patterns, exclude)


def roofline_pct(bound_s: float, device_ns_: Optional[int]) -> Optional[float]:
    """100 x the least time the work could take over the time its kernels
    took; None where the trace holds none of them."""
    if not device_ns_:
        return None
    return 100.0 * bound_s / (device_ns_ / 1e9)


def idle_pct(run) -> Optional[float]:
    if run.kernels is None or not run.kernels or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_ns(run.kernels) / 1e9 / run.window_s)


def p95(values: Sequence[float]) -> Optional[float]:
    """The 95th percentile (statistics.quantiles, exclusive method)."""
    if len(values) < 20:
        return None
    return statistics.quantiles(values, n=20)[-1]

# the convolution libraries' kernels: cuDNN's (sm90_xmma_*_cudnn, its padding
# and workspace kernels) and cuBLAS's (nvjet_*, cutlass_80_*, split-K
# reduction), which run the 1x1 convolutions
CONV = ("cudnn", "nvjet", "cutlass", "cublas")
NOT_CONV = ("at::native",)
