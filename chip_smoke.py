"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Drives the port's main paths through the entry points a user calls —
`deepdenoiser-torch denoise` (cli.main) and the frame factories of
inference/pipeline.py — at 1080p with the release weights, and checks every
CUDA kernel against its plain PyTorch version on the card. Phases, each
printing its results on its own lines; any failure raises and the run exits
non-zero:

  1. card        name, count, power limit; fails without a CUDA device
  2. build       nvcc every csrc/*.cu (ops/_build.py), ptxas report
  3. kernels     the KPN filter apply vs its plain version at the paths'
                 shapes (max|d| <= 1e-5 + 1e-5*|ref|); the five per-pass
                 fused-ingest kernels and the whole-pixel group encode vs
                 theirs at 1080p, batched and ragged shapes, for every aux
                 subset (1e-6 + 1e-6*|ref|); device times by CUDA-graph
                 replay, bytes, bound, torch.clamp's time dense and into the
                 same stack
  4. kpn-hq      joint 1080p frame: 8 KPN launches per frame, finite output,
                 PSNR gain > 0 and within 0.05 dB of the same frame in fp32
                 (TF32 off, plain filter apply), ms per frame
  5. flagship-hq the same path (no kernel of its own), gain and ms per frame
  6. flagship-max group 1080p frame through --config with the fused ingest:
                 launches per frame (group encode 1, KPN 2, no per-pass
                 launch), gain vs fp32, fused encode == plain encode, ms per
                 frame both ways
  7. aux subsets group frames with aux=(normal, depth) and (alpha,), random
                 weights: the depth-only and alpha-only bodies on a frame
                 path; then the frame's passes through the per-pass encode
                 (encode_group_inputs_per_pass) for the three aux sets: every
                 per-pass kernel launched, result == the one-launch encode
  8. rgb         combined-RGB model: cli --config, frame factory, denoise_crop
  9. flagship    joint frame with the space-to-depth stem, gain vs fp32
  10. one JSON line {"kernels": [...]}
  (with --profile, the frame phases also print device time by kernel and the
  device's busy share, from torch.profiler)
  then the card's name and power limit as nvidia-smi prints them, and last
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Imports nothing of JAX or of the JAX package. Builds into build/ (listed
in .gitignore) and writes its scratch frame and configs there.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12  # fp32 outside the tensor cores
H100_L2_BYTES = 50e6
TOL_ABS = TOL_REL = 1e-5  # same fp32 taps in the same order; FMA contraction
INGEST_TOL = 1e-6  # abs and rel: the same fp32 operations; log1pf's last bit
FRAME_TOL = 1e-5  # x max|ref|: a frame with the fused encode vs the plain encode
GAIN_TOL_DB = 0.05
FRAME_H, FRAME_W = 1080, 1920
PLANE_H, PLANE_W = 1144, 1984  # the frame with its 32 px border, as the network sees it
TIMED_FRAMES = 10
AUX_SUBSETS = [(), ("depth",), ("alpha",), ("normal", "depth"), ("normal", "depth", "alpha")]
LIGHT_GROUPS = ("diffuse", "glossy", "subsurface", "transmission")
AUX_CHANNELS = {"normal": 3, "depth": 1, "alpha": 1}
# the combined-RGB release model (weights/rgb_small_ema_f16.npz)
RGB_SMALL = dict(backbone="unet", in_channels=10, out_channels=3, base_width=32, depth=2,
                 convs_per_level=1, act="leaky_relu", compute_dtype="bfloat16",
                 predict_residual=True)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(calls, replays: int = 10) -> float:
    """Mean device ms per call: `calls` (thunks that launch on the current
    stream) are captured into one CUDA graph and the graph replayed, so the
    host's launch cost is out of the picture. The thunks rotate over buffer
    sets larger than the L2 together, so each call finds its data in device
    memory, as the frame path does."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    calls = list(calls) * max(1, 32 // len(calls))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    ms = cuda_ms(graph.replay, iters=replays, warmup=2) / len(calls)
    del graph
    return ms


def rotating(calls):
    """One thunk that runs the next of `calls` each time it is called."""
    ring = itertools.cycle(calls)
    return lambda: next(ring)()


@contextlib.contextmanager
def full_fp32():
    """Full-precision fp32 convs and matmuls (TF32 off) inside the block."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def reset_launches() -> None:
    from deepdenoiser_tpu_torch.ops import fused_ingest, kpn_apply

    kpn_apply.reset_launches()
    fused_ingest.reset_launches()


def read_launches() -> dict:
    from deepdenoiser_tpu_torch.ops import fused_ingest, kpn_apply

    return {"kpn_apply": kpn_apply.launches, **fused_ingest.launches}


def expect_launches(what: str, got: dict, frames: int = 1, **per_frame: int) -> None:
    """Every kernel's count must be its `per_frame` (default 0) x frames."""
    want = {name: per_frame.get(name, 0) * frames for name in got}
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, want {want}")


def time_frames(run, frames: int) -> list:
    """Host-clock ms of each of `frames` calls, each ended by a synchronize."""
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def check_frame(what: str, out: dict) -> None:
    comb = out["combined"]
    if tuple(comb.shape) != (FRAME_H, FRAME_W, 3) or not all(
        torch.isfinite(v).all() for v in out.values()
    ):
        raise AssertionError(f"{what}: output not finite / wrong shape {tuple(comb.shape)}")


def frames_agree(what: str, got: dict, ref: dict) -> float:
    """max over passes of max|got - ref| / max|ref|; raises above FRAME_TOL."""
    if set(got) != set(ref):
        raise AssertionError(f"{what}: passes {sorted(got)} != {sorted(ref)}")
    worst = 0.0
    for name, r in ref.items():
        rel = float((got[name] - r).abs().max() / r.abs().max().clamp_min(1e-30))
        worst = max(worst, rel)
        if not rel <= FRAME_TOL:
            raise AssertionError(f"{what}: pass {name} differs by {rel:.3e} x max|ref| "
                                 f"(limit {FRAME_TOL:g})")
    return worst


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_card() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    card = {
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "smi": nvidia_smi_line(),
    }
    log(f"[card] {card['kind']} count={card['count']} "
        f"torch={torch.__version__} cuda={torch.version.cuda} | {card['smi']}")
    return card


def phase_build() -> None:
    from deepdenoiser_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build()
    log(f"[build] {len(paths)} source(s) in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(p.name for p in paths.values()))
    for name in paths:
        lines = [ln.strip() for ln in _build.ptxas_report(name).splitlines()]
        regs = [int(m.group(1)) for ln in lines
                if (m := re.search(r"Used (\d+) registers", ln))]
        spills = sum(int(n) for ln in lines
                     for n in re.findall(r"(\d+) bytes spill", ln))
        if len(regs) <= 4:
            for line in lines:
                log(f"[build] {name}: {line}")
        log(f"[build] {name}: {len(regs)} kernel(s), {min(regs)}-{max(regs)} registers, "
            f"{spills} bytes spilled")


def _kpn_inputs(shape, k, stack_channels, gen):
    """noisy (N,H,W,C) and softmaxed weights (N,H,W,k²) on the card. With
    stack_channels, as the pipeline hands them to the kernel: the noisy slot
    is a 3-channel slice of the fp32 signal stack (24 channels in joint
    mode, the 14-channel network input in group mode) and the weights a
    view of planar (N,k²,H,W) softmax output."""
    n, h, w, c = shape
    dev = "cuda"
    if stack_channels:
        stack = torch.rand((n, h, w, stack_channels), generator=gen, device=dev)
        noisy = stack[..., 3:6]
        logits = torch.randn((n, k * k, h, w), generator=gen, device=dev)
        weights = torch.softmax(logits, dim=1).permute(0, 2, 3, 1)
    else:
        noisy = torch.rand(shape, generator=gen, device=dev)
        logits = torch.randn((n, h, w, k * k), generator=gen, device=dev)
        weights = torch.softmax(logits, dim=-1)
    return noisy, weights


def phase_kernels(card: dict) -> dict:
    """The KPN filter apply against its plain version. Returns the timing at
    the joint path's shape, with the group path's under "group"."""
    from deepdenoiser_tpu_torch.models import kpn
    from deepdenoiser_tpu_torch.ops import kpn_apply

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # (shape, k, channels of the stack the slot is cut from, path it is timed for)
    cases = [((1, PLANE_H, PLANE_W, 3), 5, 24, "joint"), ((4, PLANE_H, PLANE_W, 3), 5, 14, "group"),
             ((4, 260, 390, 3), 3, 0, None), ((1, 37, 53, 3), 5, 0, None)]
    worst = 0.0
    timings = {}
    for shape, k, stack_channels, path in cases:
        noisy, weights = _kpn_inputs(shape, k, stack_channels, gen)
        got = kpn_apply.apply_cuda(noisy, weights, k)
        ref = kpn.apply_per_pixel_kernels(noisy, weights, k)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        bad = int((err > TOL_ABS + TOL_REL * ref.abs()).sum())
        max_err = float(err.max())
        worst = max(worst, max_err)
        log(f"[kernels] kpn_apply {shape} k={k} slot of a {stack_channels or 3}-channel stack: "
            f"max|d|={max_err:.3e} over tolerance={bad}")
        if bad or not torch.isfinite(got).all():
            raise AssertionError(f"kpn_apply disagrees with its plain version at {shape} k={k}")
        del got, ref, err
        if path:  # a frame path's shape
            n, h, w, c = shape
            kernel_ms = cuda_ms(lambda: kpn_apply.apply_cuda(noisy, weights, k), iters=200 // n)
            plain_ms = cuda_ms(lambda: kpn.apply_per_pixel_kernels(noisy, weights, k), iters=20 // n)
            px = n * h * w
            nbytes = px * (c + k * k + c) * 4  # each input read once, output written once
            flops = px * c * k * k * 2
            bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
            ops_ms = flops / H100_FP32_FLOP_PER_S * 1e3
            timing = timings[path] = {
                "shape": list(shape), "k": k, "ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "flops": flops,
            }
            log(f"[kernels] kpn_apply {shape} k={k} ({path} path): {kernel_ms * 1e3:.1f} us/launch "
                f"(bound {timing['bound_ms'] * 1e3:.1f} us by {timing['bound_by']}: "
                f"{nbytes / 1e6:.1f} MB at 3.35 TB/s = {bytes_ms * 1e3:.1f} us, "
                f"{flops / 1e9:.3f} GFLOP at 67 TFLOP/s = {ops_ms * 1e3:.1f} us; "
                f"{nbytes / (kernel_ms * 1e-3) / 1e12:.2f} TB/s achieved), "
                f"plain version {plain_ms * 1e3:.1f} us | {card['smi']}")
        del noisy, weights
    torch.cuda.empty_cache()
    return {**timings["joint"], "group": timings["group"], "max_abs_err": worst}


# The per-pass fused-ingest kernels: name -> (TPU kernel it replaces, passes
# it reads, channels, elementwise operations per input pixel, and where
# encode_group_inputs_per_pass points its outputs: (channels of the stack,
# first channel of each output) for the aux set that launches it).
INGEST_KERNELS = {
    "radiance": ("deepdenoiser_tpu/ops/fused_ingest.py:57",
                 ("diffuse_direct", "diffuse_indirect", "diffuse_color"), 3, 7 * 3, (14, (0, 3))),
    "normal": ("deepdenoiser_tpu/ops/fused_ingest.py:63", ("normal",), 3, 2 * 3, (14, (9,))),
    "depth_alpha": ("deepdenoiser_tpu/ops/fused_ingest.py:67", ("depth", "alpha"), 1, 4,
                    (14, (12, 13))),
    "depth": ("deepdenoiser_tpu/ops/fused_ingest.py:72", ("depth",), 1, 2, (13, (12,))),
    "alpha": ("deepdenoiser_tpu/ops/fused_ingest.py:76", ("alpha",), 1, 2, (10, (9,))),
}


def _raw_pass(name: str, lead, gen):
    """One raw pass on the card in a range that reaches its clamps: negative
    radiance, albedo 0 (a fifth of it), normals x1.5, alpha outside [0, 1],
    negative depth."""
    lo, hi = {"normal": (-1.5, 1.5), "depth": (-2.0, 30.0), "alpha": (-0.5, 1.5),
              "direct": (-1.0, 20.0), "indirect": (-1.0, 5.0),
              "color": (-0.2, 1.0)}[name.split("_")[-1]]
    c = AUX_CHANNELS.get(name, 3)
    x = lo + (hi - lo) * torch.rand((*lead, c), generator=gen, device="cuda")
    return x.clamp_min(0.0) if name.endswith("_color") else x


def _raw_passes(lead, gen):
    """The aux passes and every light group's direct, indirect and albedo."""
    names = [*AUX_CHANNELS, *(f"{g}_{part}" for g in LIGHT_GROUPS
                              for part in ("direct", "indirect", "color"))]
    return {name: _raw_pass(name, lead, gen) for name in names}


def _ingest_err(what: str, got, ref) -> float:
    err = (got - ref).abs()
    bad = int((err > INGEST_TOL + INGEST_TOL * ref.abs()).sum())
    if bad or got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: {bad} elements over tolerance, max|d|={float(err.max()):.3e}")
    return float(err.max())


# The group encode: the TPU assembler it replaces, and the TPU kernels whose
# bodies it runs on each frame path that launches it.
GROUP_ENCODE_REPLACES = "deepdenoiser_tpu/ops/fused_ingest.py:153"
GROUP_ENCODE_BODIES = {
    "flagship-max": ["radiance", "normal", "depth_alpha"],
    "aux normal+depth": ["radiance", "normal", "depth"],
    "aux alpha": ["radiance", "alpha"],
}


def _plain_groups(pd, groups, aux):
    from deepdenoiser_tpu_torch import transforms

    return torch.stack([transforms.encode_group_inputs(pd, g, aux) for g in groups], 0)


def _per_pass_groups(pd, groups, aux, out):
    """Every group through the per-pass kernels into its slice of `out`."""
    from deepdenoiser_tpu_torch.ops import fused_ingest as fi

    for i, g in enumerate(groups):
        fi.encode_group_inputs_per_pass(pd, g, aux, out=out[i])
    return out


def phase_ingest_kernels(card: dict) -> dict:
    """The five per-pass fused-ingest kernels and the whole-pixel group
    encode against their plain versions, for every aux subset, and each
    one's time at the 1080p shape. Returns name -> timing ("group_encode"
    among the names)."""
    from deepdenoiser_tpu_torch.ops import fused_ingest as fi

    public = {"radiance": fi.encode_radiance, "normal": fi.encode_normal,
              "depth_alpha": fi.encode_depth_alpha, "depth": fi.encode_depth,
              "alpha": fi.encode_alpha}
    plain = {"radiance": fi.encode_radiance_plain, "normal": fi.encode_normal_plain,
             "depth_alpha": fi.encode_depth_alpha_plain, "depth": fi.encode_depth_plain,
             "alpha": fi.encode_alpha_plain}
    clamp = {"normal": (-1.0, 1.0), "alpha": (0.0, 1.0)}  # the one-call library versions

    def tup(x):
        return x if isinstance(x, tuple) else (x,)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    worst = {name: 0.0 for name in (*INGEST_KERNELS, "group_encode")}
    # whole tiles, a batch, and two ragged shapes: 37*53 and 7*9 pixels are no
    # multiple of the tile, so later groups start off the float4 grid
    for lead in [(FRAME_H, FRAME_W), (2, 540, 960), (37, 53), (7, 9)]:
        pd = _raw_passes(lead, gen)
        for name, (_, passes_in, *_rest) in INGEST_KERNELS.items():
            inputs = [pd[p] for p in passes_in]
            got, ref = tup(public[name](*inputs)), tup(plain[name](*inputs))
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                worst[name] = max(worst[name], _ingest_err(f"fused_ingest.{name} {lead}", g, r))
        per_pass_err = 0.0
        for aux in AUX_SUBSETS:
            ref = _plain_groups(pd, LIGHT_GROUPS, aux)
            for groups, want in ((LIGHT_GROUPS, ref), (LIGHT_GROUPS[1:2], ref[1:2])):
                got = fi.launch_group_cuda(pd, groups, aux)
                torch.cuda.synchronize()
                worst["group_encode"] = max(worst["group_encode"], _ingest_err(
                    f"fused_ingest.group_encode {lead} {aux} x{len(groups)}", got, want))
            got = fi.encode_group_inputs_per_pass(pd, "glossy", aux)
            torch.cuda.synchronize()
            per_pass_err = max(per_pass_err, _ingest_err(
                f"encode_group_inputs_per_pass {lead} {aux}", got, ref[1]))
            del ref, got, want
        log(f"[kernels] fused_ingest {lead}: max|d| "
            + ", ".join(f"{n} {e:.2e}" for n, e in worst.items())
            + f" (group encode: {len(AUX_SUBSETS)} aux subsets x 4 groups and 1 group); "
            f"per-pass group encode {per_pass_err:.2e}")
        del pd
    torch.cuda.empty_cache()

    # times at the 1080p shape, over buffer sets that together exceed the L2
    timings = {}
    lead = (FRAME_H, FRAME_W)
    npix = FRAME_H * FRAME_W
    for name, (replaces, passes_in, c, ops_px, (stack_c, firsts)) in INGEST_KERNELS.items():
        n_in, n_out = len(passes_in), len(firsts)
        nbytes = (n_in + n_out) * npix * c * 4  # each input read once, each output written once
        sets = max(2, min(16, math.ceil(4 * H100_L2_BYTES / nbytes)))
        dense_calls, stack_calls, plain_calls, lib_calls, lib_stack_calls = [], [], [], [], []
        keep = []
        for _ in range(sets):
            inputs = [_raw_pass(p, lead, gen) for p in passes_in]
            stack = torch.empty((*lead, stack_c), device="cuda")
            views = tuple(stack[..., f : f + c] for f in firsts)
            dense = tuple(torch.empty_like(inputs[0]) for _ in firsts)
            keep.append((inputs, stack, dense))
            for calls, outs in ((dense_calls, dense), (stack_calls, views)):
                calls.append(lambda i=inputs, o=outs: public[name](
                    *i, out=o if len(o) > 1 else o[0]))
            plain_calls.append(lambda i=inputs: plain[name](*i))
            if name in clamp:
                lib_calls.append(lambda i=inputs, o=dense: torch.clamp(i[0], *clamp[name], out=o[0]))
                lib_stack_calls.append(
                    lambda i=inputs, o=views: torch.clamp(i[0], *clamp[name], out=o[0]))
        # device time per launch (CUDA-graph replay), in turns, kernel and
        # library call side by side: dense, library, stack, library into the
        # stack, and back again
        def lib(calls):
            return graph_ms(calls) if calls else None

        d1, l1 = graph_ms(dense_calls), lib(lib_calls)
        s1, ls1 = graph_ms(stack_calls), lib(lib_stack_calls)
        ls2, s2 = lib(lib_stack_calls), graph_ms(stack_calls)
        l2, d2 = lib(lib_calls), graph_ms(dense_calls)
        dense_ms, stack_ms = (d1 + d2) / 2, (s1 + s2) / 2
        library_ms = (l1 + l2) / 2 if lib_calls else None
        library_stack_ms = (ls1 + ls2) / 2 if lib_calls else None
        plain_ms = graph_ms(plain_calls)
        # what a Python caller sees per call, launch cost included
        eager_ms = cuda_ms(rotating(stack_calls), iters=50 * sets)
        flops = ops_px * npix
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        ops_ms = flops / H100_FP32_FLOP_PER_S * 1e3
        timings[name] = {
            "replaces": replaces, "shape": [*lead, c], "inputs": n_in, "outputs": n_out,
            "ms": stack_ms, "dense_ms": dense_ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_stack_ms": library_stack_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops, "max_abs_err": worst[name], "buffer_sets": sets,
            "out_layout": f"channels {list(firsts)} of a {stack_c}-channel stack",
        }
        log(f"[kernels] fused_ingest.{name} {(*lead, c)} x{n_in} in, x{n_out} out: "
            f"{stack_ms * 1e3:.1f} us/launch into {timings[name]['out_layout']} "
            f"({nbytes / (stack_ms * 1e-3) / 1e12:.2f} TB/s), {dense_ms * 1e3:.1f} us dense out "
            f"({nbytes / (dense_ms * 1e-3) / 1e12:.2f} TB/s); bound {bytes_ms * 1e3:.1f} us by "
            f"{timings[name]['bound_by']} ({nbytes / 1e6:.1f} MB at 3.35 TB/s; "
            f"{flops / 1e6:.1f} MFLOP at 67 TFLOP/s = {ops_ms * 1e3:.2f} us); "
            f"plain version {plain_ms * 1e3:.1f} us; "
            + (f"torch.clamp {library_ms * 1e3:.1f} us dense out "
               f"({nbytes / (library_ms * 1e-3) / 1e12:.2f} TB/s), {library_stack_ms * 1e3:.1f} us "
               f"into the same stack; " if library_ms is not None else "")
            + f"eager call {eager_ms * 1e3:.1f} us; device times by CUDA-graph replay over "
            f"{sets} buffer sets | {card['smi']}")
        del keep, dense_calls, stack_calls, plain_calls, lib_calls, lib_stack_calls
        torch.cuda.empty_cache()
    timings["group_encode"] = _time_group_encode(card, gen, worst["group_encode"])
    return timings


def _group_encode_work(npix: int, groups: int, aux) -> tuple:
    """(bytes, operations) of one group encode: every pass read once (the
    aux passes once for all groups), every pixel of every group written
    once; 7 operations per radiance element pair, 2 per aux element."""
    a = sum(AUX_CHANNELS[x] for x in aux)
    nbytes = 4 * npix * (9 * groups + a + groups * (9 + a))
    flops = npix * (7 * 3 * groups + 2 * a)
    return nbytes, flops


def _time_group_encode(card: dict, gen, max_abs_err: float) -> dict:
    """Device time of the whole-pixel group encode at the flagship-max
    frame's shape (4 groups, 1080p, all aux passes) by CUDA-graph replay
    over three buffer sets (each 340 MB in, 464 MB out: far past the L2),
    in turns with the per-pass route it replaces on the frame path, then
    the plain version; and the kernel alone for the other aux subsets."""
    from deepdenoiser_tpu_torch.ops import fused_ingest as fi

    lead, npix, groups = (FRAME_H, FRAME_W), FRAME_H * FRAME_W, LIGHT_GROUPS
    sets = 3
    keep = [(_raw_passes(lead, gen), torch.empty((len(groups), *lead, 14), device="cuda"))
            for _ in range(sets)]
    by_aux = {}
    for aux in AUX_SUBSETS:
        c = 9 + sum(AUX_CHANNELS[x] for x in aux)
        calls = [lambda pd=pd, o=out: fi.launch_group_cuda(
            pd, groups, aux, out=o.view(-1)[: len(groups) * npix * c].view(len(groups), *lead, c))
            for pd, out in keep]
        by_aux[aux] = (graph_ms(calls), _group_encode_work(npix, len(groups), aux)[0])
    aux = AUX_SUBSETS[-1]
    kernel_calls = [lambda pd=pd, o=out: fi.launch_group_cuda(pd, groups, aux, out=o)
                    for pd, out in keep]
    per_pass_calls = [lambda pd=pd, o=out: _per_pass_groups(pd, groups, aux, o) for pd, out in keep]
    plain_calls = [lambda pd=pd: _plain_groups(pd, groups, aux) for pd, _ in keep]
    k1, p1 = graph_ms(kernel_calls), graph_ms(per_pass_calls)
    p2, k2 = graph_ms(per_pass_calls), graph_ms(kernel_calls)
    kernel_ms, per_pass_ms = (k1 + k2) / 2, (p1 + p2) / 2
    plain_ms = graph_ms(plain_calls, replays=3)
    eager_ms = cuda_ms(rotating(kernel_calls), iters=30)
    nbytes, flops = _group_encode_work(npix, len(groups), aux)
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = flops / H100_FP32_FLOP_PER_S * 1e3
    tile = fi.group_tile_pixels(14)
    timing = {
        "replaces": GROUP_ENCODE_REPLACES, "shape": [len(groups), *lead, 14], "ms": kernel_ms,
        "eager_ms": eager_ms, "plain_ms": plain_ms, "per_pass_ms": per_pass_ms,
        "library_ms": None,  # no single PyTorch call encodes and interleaves the passes
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": nbytes, "flops": flops, "max_abs_err": max_abs_err, "buffer_sets": sets,
        "tile_pixels": tile, "blocks": math.ceil(npix / tile),
        "ms_by_aux": {"+".join(a) or "none": ms for a, (ms, _) in by_aux.items()},
    }
    log(f"[kernels] fused_ingest.group_encode {tuple(timing['shape'])}, {len(groups)} groups x "
        f"{npix} pixels in {timing['blocks']} tiles of {tile}: {kernel_ms * 1e3:.1f} us/launch "
        f"({nbytes / (kernel_ms * 1e-3) / 1e12:.2f} TB/s); bound {timing['bound_ms'] * 1e3:.1f} us "
        f"by {timing['bound_by']} ({nbytes / 1e6:.1f} MB at 3.35 TB/s; {flops / 1e6:.1f} MFLOP at "
        f"67 TFLOP/s = {ops_ms * 1e3:.2f} us); the per-pass route (12 launches + 4 albedo copies) "
        f"{per_pass_ms * 1e3:.1f} us; plain version {plain_ms * 1e3:.1f} us; eager call "
        f"{eager_ms * 1e3:.1f} us; device times by CUDA-graph replay over {sets} buffer sets, in "
        f"turns kernel/per-pass/per-pass/kernel | {card['smi']}")
    log("[kernels] fused_ingest.group_encode by aux subset, 4 groups at 1080p: "
        + "; ".join(f"{'+'.join(a) or 'none'} {ms * 1e3:.1f} us "
                    f"({nb / (ms * 1e-3) / 1e12:.2f} TB/s, bound "
                    f"{nb / H100_BYTES_PER_S * 1e6:.1f} us)" for a, (ms, nb) in by_aux.items()))
    del keep, kernel_calls, per_pass_calls, plain_calls
    torch.cuda.empty_cache()
    return timing


def _fourier_frame():
    from deepdenoiser_tpu_torch.data import synthetic

    clean = synthetic.generate_clean_passes(FRAME_H, FRAME_W, seed=0)
    noisy = synthetic.add_mc_noise(clean, spp=4, seed=1)
    return clean, noisy


def _gain_db(out_combined, noisy_combined, clean_combined) -> float:
    from deepdenoiser_tpu_torch.ops import metrics

    ref = metrics.tonemap_for_metrics(clean_combined)
    return float(
        metrics.psnr(metrics.tonemap_for_metrics(out_combined), ref)
        - metrics.psnr(metrics.tonemap_for_metrics(noisy_combined), ref)
    )


def profile_frames(preset: str, run, card: dict, frames: int = 3, top: int = 12) -> None:
    """Device time by kernel over `frames` frames (torch.profiler), and the
    share of the wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"[{preset}] profile over {frames} frames: device busy {busy_us / frames / 1e3:.3f} ms/frame "
        f"of {wall_us / frames / 1e3:.3f} ms/frame wall ({100 * busy_us / wall_us:.1f}% busy) "
        f"| {card['smi']}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[{preset}]   {e.self_device_time_total / frames / 1e3:8.3f} ms/frame "
            f"{e.count // frames:4d}x  {e.key[:110]}")


def _frame_on_card(frame: dict):
    dev = torch.device("cuda")
    return (torch.from_numpy(frame["clean"]["combined"]).to(dev),
            torch.from_numpy(frame["noisy"]["combined"]).to(dev))


def _cli_denoise(what: str, frame: dict, source: list, weights: str, mode: str):
    """`deepdenoiser-torch denoise` on the scratch frame (runs on cuda by
    default), with every launch count set to 0 just before and read just
    after. Returns (combined output on the card, launch counts)."""
    from deepdenoiser_tpu_torch import cli
    from deepdenoiser_tpu_torch.data import exr

    out_exr = WORK / f"{what}_combined.exr"
    reset_launches()
    rc = cli.main(["denoise", *source, "--weights", weights, "--frame", str(frame["dir"]),
                   "--out", str(out_exr), "--mode", mode])
    torch.cuda.synchronize()
    launches = read_launches()
    if rc != 0:
        raise AssertionError(f"{what}: cli denoise returned {rc}")
    out = torch.from_numpy(exr.read_exr(out_exr)).to("cuda")
    if tuple(out.shape) != (FRAME_H, FRAME_W, 3) or not torch.isfinite(out).all():
        raise AssertionError(f"{what}: cli output {tuple(out.shape)} not finite/shaped")
    return out, launches


def phase_preset(preset: str, weights: str, frame: dict, card: dict,
                 kernel_launches_per_frame: int, check_fp32: bool,
                 profile: bool = False, timed_frames: int = TIMED_FRAMES) -> dict:
    """A joint-mode preset: through the CLI, then through the factory, timed."""
    from deepdenoiser_tpu_torch import config, weights_io
    from deepdenoiser_tpu_torch.inference import pipeline
    from deepdenoiser_tpu_torch.models import kpn

    noisy = frame["noisy"]
    dev = torch.device("cuda")
    clean_c, noisy_c = _frame_on_card(frame)
    wpath = str(ROOT / "weights" / weights)
    res = {"preset": preset}

    # the user's entry point
    cli_out, cli_launches = _cli_denoise(preset, frame, ["--preset", preset], wpath, "joint")
    expect_launches(f"{preset} cli frame", cli_launches, kpn_apply=kernel_launches_per_frame)
    res["cli_launches"] = cli_launches["kpn_apply"]
    res["cli_gain_db"] = _gain_db(cli_out, noisy_c, clean_c)

    # the same path through the pipeline factory, timed
    cfg = config.validate_channels(config.PRESETS[preset])
    params = weights_io.load_release_params(wpath)
    denoise, grid = pipeline.make_joint_frame_denoiser(cfg.model, cfg.infer, FRAME_H, FRAME_W, params)
    frame_dev = {k: torch.from_numpy(v).to(dev) for k, v in noisy.items()}
    for _ in range(2):
        out = denoise(frame_dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times = time_frames(lambda: denoise(frame_dev), timed_frames)
    launches = read_launches()
    expect_launches(f"{preset} over {timed_frames} frames", launches, timed_frames,
                    kpn_apply=kernel_launches_per_frame)
    out = denoise(frame_dev)
    check_frame(preset, out)
    res.update(
        grid=f"{grid.net_h}x{grid.net_w} (halo {grid.halo})",
        gain_db=_gain_db(out["combined"], noisy_c, clean_c),
        ms_median=statistics.median(times), ms_min=min(times), ms_max=max(times),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches_per_frame=launches["kpn_apply"] / timed_frames,
    )
    if res["gain_db"] <= 0 or res["cli_gain_db"] <= 0:
        raise AssertionError(f"{preset}: no PSNR gain ({res['gain_db']}, cli {res['cli_gain_db']})")
    del out

    if check_fp32:
        # fp32 reference: full-precision convs (TF32 off for cuDNN and
        # matmuls) and the plain filter apply instead of the kernel
        with full_fp32():
            icfg = dataclasses.replace(cfg.infer, compute_dtype="float32")
            ref_fn, _ = pipeline.make_joint_frame_denoiser(cfg.model, icfg, FRAME_H, FRAME_W, params)
            if cfg.model.kernel_prediction:
                ref_fn.model.KernelPredictionHead_0.filter_apply = kpn.apply_per_pixel_kernels
            ref_out = ref_fn(frame_dev)["combined"]
            torch.cuda.synchronize()
        res["fp32_gain_db"] = _gain_db(ref_out, noisy_c, clean_c)
        diff = abs(res["gain_db"] - res["fp32_gain_db"])
        if not torch.isfinite(ref_out).all() or diff > GAIN_TOL_DB:
            raise AssertionError(f"{preset}: bf16 gain {res['gain_db']:.4f} dB vs fp32 "
                                 f"{res['fp32_gain_db']:.4f} dB differ by {diff:.4f} > {GAIN_TOL_DB}")
        del ref_fn, ref_out
    if profile:
        profile_frames(preset, lambda: denoise(frame_dev), card)
    del denoise
    torch.cuda.empty_cache()
    log(f"[{preset}] 1080p joint frame, grid {res['grid']}: "
        f"{res['ms_median']:.2f} ms/frame median of {timed_frames} "
        f"(min {res['ms_min']:.2f}, max {res['ms_max']:.2f}; host clock around synchronize), "
        f"peak {res['peak_gib']:.2f} GiB | {card['smi']}")
    log(f"[{preset}] PSNR gain {res['gain_db']:.4f} dB (cli {res['cli_gain_db']:.4f} dB"
        + (f", fp32 reference {res['fp32_gain_db']:.4f} dB" if check_fp32 else "")
        + f"); kpn_apply launches: cli frame {res['cli_launches']}, "
        f"{res['launches_per_frame']:g} per timed frame")
    return res


def _fp32_frame(frame: dict):
    """The noisy passes on the card in fp32, as the loaders hand them over."""
    import numpy as np

    return {k: torch.from_numpy(np.asarray(v, dtype=np.float32)).to("cuda")
            for k, v in frame["noisy"].items()}


def phase_flagship_max(frame: dict, card: dict, profile: bool = False,
                       timed_frames: int = 5) -> dict:
    """The group-mode path at full width: flagship-max (UNet base 48, depth
    3, 2-slot 5x5 KPN) with weights/kpn_ema_f16.npz, four light groups as
    one (4, 1144, 1984, 14) batch, the fused ingest chosen through a config
    JSON as a user would: one group-encode launch per frame and no per-pass
    launch."""
    from deepdenoiser_tpu_torch import config, weights_io
    from deepdenoiser_tpu_torch.inference import pipeline
    from deepdenoiser_tpu_torch.models import kpn

    what = "flagship-max"
    per_frame = dict(kpn_apply=2, group_encode=1)
    clean_c, noisy_c = _frame_on_card(frame)
    wpath = str(ROOT / "weights" / "kpn_ema_f16.npz")
    preset = config.PRESETS[what]
    cfg_path = WORK / "flagship_max_fused_ingest.json"
    config.save(dataclasses.replace(
        preset, infer=dataclasses.replace(preset.infer, use_pallas_ingest=True)), cfg_path)

    cli_out, cli_launches = _cli_denoise(what, frame, ["--config", str(cfg_path)], wpath, "group")
    expect_launches(f"{what} cli frame", cli_launches, **per_frame)
    res = {"cli_launches": cli_launches, "cli_gain_db": _gain_db(cli_out, noisy_c, clean_c)}
    del cli_out

    cfg = config.validate_channels(config.load(cfg_path))
    if not cfg.infer.use_pallas_ingest or cfg.model.in_channels != 14:
        raise AssertionError(f"{what}: config did not round-trip: {cfg}")
    plain_icfg = dataclasses.replace(cfg.infer, use_pallas_ingest=False)
    params = weights_io.load_release_params(wpath)
    fused, grid = pipeline.make_group_frame_denoiser(cfg.model, cfg.infer, FRAME_H, FRAME_W, params)
    plain, _ = pipeline.make_group_frame_denoiser(cfg.model, plain_icfg, FRAME_H, FRAME_W, params)
    frame_dev = _fp32_frame(frame)
    for den in (fused, plain):
        for _ in range(2):
            den(frame_dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # in turns on the one card: fused, plain, plain, fused
    reset_launches()
    t_fused = time_frames(lambda: fused(frame_dev), timed_frames)
    launches = read_launches()
    expect_launches(f"{what} over {timed_frames} fused frames", launches, timed_frames, **per_frame)
    reset_launches()
    t_plain = time_frames(lambda: plain(frame_dev), 2 * timed_frames)
    expect_launches(f"{what} over {2 * timed_frames} plain-encode frames", read_launches(),
                    2 * timed_frames, kpn_apply=2)
    t_fused += time_frames(lambda: fused(frame_dev), timed_frames)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    # the encode alone, both ways (CUDA events; launch cost included)
    res["encode_fused_ms"] = cuda_ms(lambda: fused.encode(frame_dev), iters=20)
    res["encode_plain_ms"] = cuda_ms(lambda: plain.encode(frame_dev), iters=20)

    out_fused, out_plain = fused(frame_dev), plain(frame_dev)
    check_frame(what, out_fused)
    check_frame(f"{what} (plain encode)", out_plain)
    res.update(
        gain_db=_gain_db(out_fused["combined"], noisy_c, clean_c),
        plain_gain_db=_gain_db(out_plain["combined"], noisy_c, clean_c),
        bf16_fused_vs_plain=max(
            float((out_fused[k] - v).abs().max() / v.abs().max().clamp_min(1e-30))
            for k, v in out_plain.items()),
        ms_fused=statistics.median(t_fused), ms_plain=statistics.median(t_plain),
        fused_range=(min(t_fused), max(t_fused)), plain_range=(min(t_plain), max(t_plain)),
    )
    if min(res["gain_db"], res["plain_gain_db"], res["cli_gain_db"]) <= 0:
        raise AssertionError(f"{what}: no PSNR gain: {res}")
    del out_fused, out_plain
    if profile:
        profile_frames(f"{what} fused ingest", lambda: fused(frame_dev), card)
        profile_frames(f"{what} plain encode", lambda: plain(frame_dev), card)
    del fused, plain
    torch.cuda.empty_cache()

    # fp32 reference (TF32 off, plain filter apply, plain encode); then the
    # same fp32 network behind the fused encode must give the same frame
    with full_fp32():
        outs = {}
        for key, icfg in (("plain", plain_icfg), ("fused", cfg.infer)):
            icfg = dataclasses.replace(icfg, compute_dtype="float32")
            den, _ = pipeline.make_group_frame_denoiser(cfg.model, icfg, FRAME_H, FRAME_W, params)
            den.model.KernelPredictionHead_0.filter_apply = kpn.apply_per_pixel_kernels
            reset_launches()
            outs[key] = den(frame_dev)
            torch.cuda.synchronize()
            expect_launches(f"{what} fp32 {key} encode", read_launches(),
                            **({k: v for k, v in per_frame.items() if k != "kpn_apply"}
                               if key == "fused" else {}))
            del den
            torch.cuda.empty_cache()
    check_frame(f"{what} fp32", outs["plain"])
    res["fp32_gain_db"] = _gain_db(outs["plain"]["combined"], noisy_c, clean_c)
    res["fp32_fused_vs_plain"] = frames_agree(f"{what} fp32, fused vs plain encode",
                                              outs["fused"], outs["plain"])
    diff = abs(res["gain_db"] - res["fp32_gain_db"])
    if diff > GAIN_TOL_DB:
        raise AssertionError(f"{what}: bf16 gain {res['gain_db']:.4f} dB vs fp32 "
                             f"{res['fp32_gain_db']:.4f} dB differ by {diff:.4f} > {GAIN_TOL_DB}")
    del outs
    torch.cuda.empty_cache()
    log(f"[{what}] 1080p group frame, 4 groups in one batch, grid {grid.net_h}x{grid.net_w} "
        f"(halo {grid.halo}): fused ingest {res['ms_fused']:.2f} ms/frame median of "
        f"{len(t_fused)} (min {res['fused_range'][0]:.2f}, max {res['fused_range'][1]:.2f}), "
        f"plain encode {res['ms_plain']:.2f} ms/frame median of {len(t_plain)} "
        f"(min {res['plain_range'][0]:.2f}, max {res['plain_range'][1]:.2f}; host clock around "
        f"synchronize, in turns fused/plain/plain/fused), peak {res['peak_gib']:.2f} GiB "
        f"| {card['smi']}")
    log(f"[{what}] encode of the four groups alone: fused {res['encode_fused_ms']:.3f} ms "
        f"(1 launch), plain {res['encode_plain_ms']:.3f} ms (CUDA events "
        f"around 20 calls) | {card['smi']}")
    log(f"[{what}] PSNR gain {res['gain_db']:.4f} dB (cli {res['cli_gain_db']:.4f} dB, plain "
        f"encode {res['plain_gain_db']:.4f} dB, fp32 reference {res['fp32_gain_db']:.4f} dB); "
        f"fused vs plain encode, max over passes of max|d|/max|ref|: fp32 "
        f"{res['fp32_fused_vs_plain']:.2e} (limit {FRAME_TOL:g}), bf16 "
        f"{res['bf16_fused_vs_plain']:.2e}; launches per frame: {cli_launches}")
    return res


def phase_aux_subsets(frame: dict, card: dict) -> dict:
    """Group frames whose aux set leaves depth or alpha alone, so the
    depth-only and alpha-only bodies run on a frame path: a base-16, depth-2
    KPN model with seeded random weights, 1080p, fp32. Returns path name ->
    group-encode launches of that frame."""
    from deepdenoiser_tpu_torch import config, transforms, weights_io
    from deepdenoiser_tpu_torch.inference import pipeline
    from deepdenoiser_tpu_torch.models import factory

    frame_dev = _fp32_frame(frame)
    counts = {}
    for aux in (("normal", "depth"), ("alpha",)):
        per_frame = dict(kpn_apply=2, group_encode=1)
        mcfg = factory.ModelConfig(
            in_channels=transforms.group_input_channels(aux), out_channels=6, base_width=16,
            depth=2, act="leaky_relu", kernel_prediction=True, kpn_size=3, kpn_slots=2)
        torch.manual_seed(0)
        params = weights_io.params_from_state_dict(factory.build_model(mcfg).state_dict())
        outs = {}
        for fused in (True, False):
            icfg = config.InferenceConfig(border=32, compute_dtype="float32",
                                          use_pallas_ingest=fused)
            den, _ = pipeline.make_group_frame_denoiser(mcfg, icfg, FRAME_H, FRAME_W, params,
                                                        aux=aux)
            reset_launches()
            outs[fused] = den(frame_dev)
            torch.cuda.synchronize()
            launches = read_launches()
            expect_launches(f"group frame aux={aux} fused={fused}", launches,
                            **(per_frame if fused else dict(kpn_apply=2)))
            if fused:
                counts["aux " + "+".join(aux)] = launches["group_encode"]
            del den
        check_frame(f"group frame aux={aux}", outs[True])
        rel = frames_agree(f"group frame aux={aux}, fused vs plain encode", outs[True], outs[False])
        log(f"[aux {'+'.join(aux)}] 1080p group frame, {mcfg.in_channels} input channels, random "
            f"base-16 depth-2 KPN, fp32: launches {per_frame}; fused vs plain encode "
            f"max|d|/max|ref| {rel:.2e} (limit {FRAME_TOL:g}) | {card['smi']}")
        del outs
        torch.cuda.empty_cache()
    return counts


def phase_per_pass_encode(frame: dict, card: dict) -> dict:
    """The path of the per-pass kernels: the frame's four groups encoded by
    encode_group_inputs_per_pass, for the three aux sets of the group frames
    above, so that every per-pass kernel is launched on the frame's own
    passes; each result must equal the one-launch encode to the last bit.
    Returns kernel name -> launches of the run that reaches it."""
    from deepdenoiser_tpu_torch.ops import fused_ingest as fi

    frame_dev = _fp32_frame(frame)
    counts = {}
    for aux, per_run in [
        (("normal", "depth", "alpha"), dict(radiance=4, normal=4, depth_alpha=4)),
        (("normal", "depth"), dict(radiance=4, normal=4, depth=4)),
        (("alpha",), dict(radiance=4, alpha=4)),
    ]:
        c = 9 + sum(AUX_CHANNELS[a] for a in aux)
        out = torch.empty((len(LIGHT_GROUPS), FRAME_H, FRAME_W, c), device="cuda")
        reset_launches()
        _per_pass_groups(frame_dev, LIGHT_GROUPS, aux, out)
        torch.cuda.synchronize()
        launches = read_launches()
        expect_launches(f"per-pass encode aux={aux}", launches, **per_run)
        one = fi.encode_groups_fused(frame_dev, LIGHT_GROUPS, aux)
        torch.cuda.synchronize()
        if not torch.equal(out, one):
            raise AssertionError(f"per-pass encode aux={aux} differs from the one-launch encode: "
                                 f"max|d|={float((out - one).abs().max()):.3e}")
        for name, n in per_run.items():
            counts.setdefault(name, n)
        del out, one
    per_pass_ms = cuda_ms(lambda: _per_pass_groups(
        frame_dev, LIGHT_GROUPS, ("normal", "depth", "alpha"),
        torch.empty((len(LIGHT_GROUPS), FRAME_H, FRAME_W, 14), device="cuda")), iters=20)
    one_ms = cuda_ms(lambda: fi.encode_groups_fused(frame_dev, LIGHT_GROUPS), iters=20)
    log(f"[per-pass encode] the frame's 4 groups through the per-pass kernels, 3 aux sets: "
        f"launches {counts}, each result == the one-launch encode; all aux passes: "
        f"{per_pass_ms:.3f} ms per frame (12 launches + 4 albedo copies) against "
        f"{one_ms:.3f} ms in one launch (CUDA events around 20 calls) | {card['smi']}")
    torch.cuda.empty_cache()
    return counts


def phase_rgb(frame: dict, card: dict, timed_frames: int = 5) -> None:
    """Combined-RGB mode with weights/rgb_small_ema_f16.npz: the CLI through
    a config JSON, the frame factory and the single-crop denoise. No kernel
    of its own."""
    from deepdenoiser_tpu_torch import config, weights_io
    from deepdenoiser_tpu_torch.inference import pipeline
    from deepdenoiser_tpu_torch.models import factory

    clean_c, noisy_c = _frame_on_card(frame)
    wpath = str(ROOT / "weights" / "rgb_small_ema_f16.npz")
    cfg_path = WORK / "rgb_small.json"
    config.save(config.ExperimentConfig(
        name="rgb-small", model=factory.ModelConfig(**RGB_SMALL),
        data=config.DataConfig(mode="rgb")), cfg_path)
    cli_out, cli_launches = _cli_denoise("rgb-small", frame, ["--config", str(cfg_path)], wpath, "rgb")
    expect_launches("rgb-small cli frame", cli_launches)
    cli_gain = _gain_db(cli_out, noisy_c, clean_c)

    cfg = config.validate_channels(config.load(cfg_path))
    params = weights_io.load_release_params(wpath)
    den, grid = pipeline.make_rgb_frame_denoiser(cfg.model, cfg.infer, FRAME_H, FRAME_W, params)
    frame_dev = _fp32_frame(frame)
    for _ in range(2):
        den(frame_dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = time_frames(lambda: den(frame_dev), timed_frames)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    out = den(frame_dev)["combined"]
    crop = pipeline.denoise_crop(cfg.model, params, frame_dev)
    torch.cuda.synchronize()
    gains = {"cli": cli_gain, "frame": _gain_db(out, noisy_c, clean_c),
             "denoise_crop": _gain_db(crop, noisy_c, clean_c)}
    for name, t in (("frame", out), ("denoise_crop", crop)):
        if tuple(t.shape) != (FRAME_H, FRAME_W, 3) or not torch.isfinite(t).all():
            raise AssertionError(f"rgb-small {name}: output {tuple(t.shape)} not finite/shaped")
    if min(gains.values()) <= 0:
        raise AssertionError(f"rgb-small: no PSNR gain: {gains}")
    log(f"[rgb-small] 1080p rgb frame, grid {grid.net_h}x{grid.net_w} (halo {grid.halo}): "
        f"{statistics.median(times):.2f} ms/frame median of {timed_frames} (min {min(times):.2f}, "
        f"max {max(times):.2f}; host clock around synchronize), peak {peak_gib:.2f} GiB "
        f"| {card['smi']}")
    log("[rgb-small] PSNR gain " + ", ".join(f"{k} {v:.4f} dB" for k, v in gains.items())
        + " (denoise_crop: the whole frame as one unpadded crop)")
    del den, out, crop
    torch.cuda.empty_cache()


def _kernel_row(name: str, source: str, replaces: str, launches: int, t: dict, **extra) -> dict:
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": t["max_abs_err"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t.get("library_ms"),  # None: no single PyTorch call computes it
        "us": t["ms"] * 1e3, "bound_us": t["bound_ms"] * 1e3, "shape": t["shape"],
        "bytes": t["bytes"], "flops": t["flops"], **extra,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="smoke run of the PyTorch port on one CUDA card")
    ap.add_argument("--profile", action="store_true",
                    help="also print each preset's device time by kernel (torch.profiler)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    card = phase_card()
    phase_build()
    kern = phase_kernels(card)
    ingest = phase_ingest_kernels(card)

    from deepdenoiser_tpu_torch.data import exr

    t0 = time.perf_counter()
    clean, noisy = _fourier_frame()
    frame_dir = WORK / "fourier_1080p_spp4"
    exr.save_frame_dir(frame_dir, noisy)
    log(f"[frame] Fourier family 1080p spp4 written to {frame_dir.relative_to(ROOT)} "
        f"in {time.perf_counter() - t0:.1f} s")
    frame = {"clean": clean, "noisy": noisy, "dir": frame_dir}
    kpn_res = phase_preset("kpn-hq", "kpn_hq_ema_f16.npz", frame, card,
                           kernel_launches_per_frame=8, check_fp32=True, profile=args.profile)
    phase_preset("flagship-hq", "flagship_hq_ema_f16.npz", frame, card,
                 kernel_launches_per_frame=0, check_fp32=False, profile=args.profile)
    max_res = phase_flagship_max(frame, card, profile=args.profile)
    aux_counts = phase_aux_subsets(frame, card)
    per_pass_counts = phase_per_pass_encode(frame, card)
    phase_rgb(frame, card)
    phase_preset("flagship", "flagship_ema_f16.npz", frame, card, kernel_launches_per_frame=0,
                 check_fp32=True, profile=args.profile, timed_frames=5)

    group = kern["group"]
    kernels = [_kernel_row(
        "kpn_apply", "deepdenoiser_tpu_torch/csrc/kpn_apply.cu",
        "deepdenoiser_tpu/ops/kpn_pallas.py:59", kpn_res["cli_launches"], kern,
        launches_per_frame=kpn_res["launches_per_frame"], k=kern["k"],
        launches_group_frame=max_res["cli_launches"]["kpn_apply"],
        group_shape=group["shape"], group_ms=group["ms"], group_plain_ms=group["plain_ms"],
        group_bound_ms=group["bound_ms"],
    )]
    group_t = ingest.pop("group_encode")
    for name, t in ingest.items():
        # launches: of the per-pass encode of the frame's passes (the group
        # frames run these bodies inside the group encode's launch)
        kernels.append(_kernel_row(
            f"fused_ingest.{name}", "deepdenoiser_tpu_torch/csrc/fused_ingest.cu", t["replaces"],
            per_pass_counts.get(name, 0), t, dense_ms=t["dense_ms"], eager_ms=t["eager_ms"],
            library_stack_ms=t["library_stack_ms"], out_layout=t["out_layout"],
            buffer_sets=t["buffer_sets"], path="per-pass encode of the frame's passes",
        ))
    # launches: of the flagship-max cli frame; the bodies it runs on each
    # frame path are the TPU kernels the per-pass rows name
    kernels.append(_kernel_row(
        "fused_ingest.group_encode", "deepdenoiser_tpu_torch/csrc/fused_ingest.cu",
        group_t["replaces"], max_res["cli_launches"]["group_encode"], group_t,
        eager_ms=group_t["eager_ms"], per_pass_ms=group_t["per_pass_ms"],
        ms_by_aux=group_t["ms_by_aux"], tile_pixels=group_t["tile_pixels"],
        blocks=group_t["blocks"], buffer_sets=group_t["buffer_sets"],
        launches_by_path={"flagship-max": max_res["cli_launches"]["group_encode"], **aux_counts},
        bodies_by_path={path: [ingest[b]["replaces"] for b in bodies]
                        for path, bodies in GROUP_ENCODE_BODIES.items()},
    ))
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        raise AssertionError(f"kernels launched on no path: {idle}")
    log(f"[done] all phases in {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                             "count": card["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
