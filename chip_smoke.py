"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Drives the port's main paths through the entry points a user calls —
`deepdenoiser-torch denoise` (cli.main) and the frame factories of
inference/pipeline.py at 1080p with the release weights; `synth-data`,
`prepare-data`, `train` and `denoise --checkpoint` for kpn-hq at the
training recipe's batch and crop — and checks every CUDA kernel against
its plain PyTorch version on the card. Phases, each
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
  10. tiled 4K   kpn-hq at 2160x3840 (the 1080p frame mirrored 2x2), tile 512,
                 tile_batch 8: 5 lazy chunks of (8, 656, 656, 41), 40 KPN
                 launches per frame; against the same frame whole with the
                 certified halo: ms per frame and peak memory of both, bf16
                 gains within 0.05 dB; at 1080p in fp32 (TF32 off) tiled ==
                 whole within 1e-4 x max|ref| per pass
  11. feather    flagship-max 1080p group frame, tile 512, tile_batch 8, fused
                 ingest: exact tiled == whole (fp32, 1e-4), feathered stitch
                 finite and close to exact (reported), ms per frame in bf16
  12. tiramisu   tiramisu-lt1, tiramisu-fast, tiramisu at 1080p: as phase 5
                 with the fp32 check (bf16 gain within 0.15 dB of fp32)
  13. multiscale unet-multiscale, seeded random weights, fp32: finite, median
  14. flags      flagship-flags-shaped joint frame without the subsurface
                 group: no subsurface passes out, combined == recompose
  15. sequence   run_sequence over 4 noisy 1080p frames with flagship-hq (PSNR
                 and SSIM on the device), and `deepdenoiser-torch eval` over a
                 small render root written to a temporary directory
  16. train-kernels  K1's backward entry points (d_w, d_noisy) vs the plain
                 backward at the training shape (16,96,96,3), the joint 1080p
                 plane, k=3 and C=1, 4 (1e-5 + 1e-5*|ref|); device times by
                 CUDA-graph replay, bytes, bound, the plain version's time
  17. train-parity   one make_train_step step of a small joint KPN (fp32,
                 TF32 off) on the card vs the CPU from the same state and batch:
                 loss and grad_norm within rel 1e-5, parameters within 2 lr,
                 and within 1e-3 lr wherever |grad| > 1e-5 of the global norm
  18. train      kpn-hq, batch 16, crop 96: synth-data -> prepare-data ->
                 `train` 20 steps (8 forward, 8 d_w and 0 d_noisy launches a
                 step, counted apart from the eval's; eval and preview at step
                 20) -> `train` resumed to 30 (the metrics file continues) ->
                 `denoise --checkpoint --ema` on the 1080p frame; ms/step,
                 samples/s, Mpx/s, peak memory, the loss curve; where a step's
                 time goes (the loader alone, fit's loop body whole and split);
                 then 100 make_train_step steps on one fixed batch (the loss
                 must halve) and flagship-hq's ms/step over 30 beside it
  19. one JSON line {"kernels": [...]}
  (with --profile, the frame phases and the train steps also print device
  time by kernel and the device's busy share, from torch.profiler)
  then the card's name and power limit as nvidia-smi prints them, and last
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Imports nothing of JAX or of the JAX package. Builds into build/ (listed
in .gitignore) and writes its scratch frame and configs there.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
TILED_TOL = 1e-4  # x max|ref|: a tiled fp32 frame vs the whole frame on the same plane
GAIN_TOL_DB = 0.05
# bf16 against fp32 for the tiramisu presets: the dense stack rounds to bf16
# at every concat, which costs more than in the UNets
TIRAMISU_GAIN_TOL_DB = 0.15
FRAME_H, FRAME_W = 1080, 1920
PLANE_H, PLANE_W = 1144, 1984  # the frame with its 32 px border, as the network sees it
UHD_H, UHD_W = 2160, 3840
TILE, TILE_BATCH, NET_TILE = 512, 8, 656  # 512 px cores + the certified halo 67 -> 72 per side
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

    return {"kpn_apply": kpn_apply.launches, "kpn_apply_bwd_weights": kpn_apply.bwd_weights_launches,
            "kpn_apply_bwd_noisy": kpn_apply.bwd_noisy_launches, **fused_ingest.launches}


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


def check_frame(what: str, out: dict, hw=None) -> None:
    comb = out["combined"]
    if tuple(comb.shape) != (*(hw or (FRAME_H, FRAME_W)), 3) or not all(
        torch.isfinite(v).all() for v in out.values()
    ):
        raise AssertionError(f"{what}: output not finite / wrong shape {tuple(comb.shape)}")


def frames_agree(what: str, got: dict, ref: dict, tol: float = FRAME_TOL) -> float:
    """max over passes of max|got - ref| / max|ref|; raises above `tol`."""
    if set(got) != set(ref):
        raise AssertionError(f"{what}: passes {sorted(got)} != {sorted(ref)}")
    worst = 0.0
    for name, r in ref.items():
        rel = float((got[name] - r).abs().max() / r.abs().max().clamp_min(1e-30))
        worst = max(worst, rel)
        if not rel <= tol:
            raise AssertionError(f"{what}: pass {name} differs by {rel:.3e} x max|ref| "
                                 f"(limit {tol:g})")
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
    the joint path's shape, with the group path's under "group" and the
    tiled frame's tile batch under "tile"."""
    from deepdenoiser_tpu_torch.models import kpn
    from deepdenoiser_tpu_torch.ops import kpn_apply

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # (shape, k, channels of the stack the slot is cut from, path it is timed for)
    cases = [((1, PLANE_H, PLANE_W, 3), 5, 24, "joint"), ((4, PLANE_H, PLANE_W, 3), 5, 14, "group"),
             ((TILE_BATCH, NET_TILE, NET_TILE, 3), 5, 24, "tile"),  # a chunk of a tiled joint frame
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
    return {**timings["joint"], "group": timings["group"], "tile": timings["tile"],
            "max_abs_err": worst}


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
                 profile: bool = False, timed_frames: int = TIMED_FRAMES,
                 gain_tol: float = GAIN_TOL_DB) -> dict:
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
        if not torch.isfinite(ref_out).all() or diff > gain_tol:
            raise AssertionError(f"{preset}: bf16 gain {res['gain_db']:.4f} dB vs fp32 "
                                 f"{res['fp32_gain_db']:.4f} dB differ by {diff:.4f} > {gain_tol}")
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
        + (f", fp32 reference {res['fp32_gain_db']:.4f} dB, limit {gain_tol} dB apart"
           if check_fp32 else "")
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


def _mirror_2x2(x):
    """(H, W, C) -> (2H, 2W, C): the frame beside its mirror image, over both
    mirrored top to bottom. Seamless, and as cheap as a copy."""
    import numpy as np

    top = np.concatenate([x, x[:, ::-1]], axis=1)
    return np.ascontiguousarray(np.concatenate([top, top[::-1]], axis=0), dtype=np.float32)


def _timed(den, frame_dev, frames: int, warmup: int = 1):
    """(times of `frames` synchronised calls, peak GiB over them, last output)."""
    for _ in range(warmup):
        den(frame_dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = time_frames(lambda: den(frame_dev), frames)
    peak = torch.cuda.max_memory_allocated() / 2**30
    return times, peak, den(frame_dev)


def phase_tiled_4k(frame: dict, card: dict, profile: bool = False, timed_frames: int = 3) -> dict:
    """kpn-hq over a 4K frame in tiles, through the memory-bounded lazy
    chunks, against the same frame run whole with the certified halo; then
    tiled against whole in fp32 at 1080p. Returns the launches of one tiled
    4K frame."""
    from deepdenoiser_tpu_torch import config, weights_io
    from deepdenoiser_tpu_torch.inference import pipeline

    what = "kpn-hq 4K"
    cfg = config.validate_channels(config.PRESETS["kpn-hq"])
    params = weights_io.load_release_params(str(ROOT / "weights" / "kpn_hq_ema_f16.npz"))
    tiled_cfg = dataclasses.replace(cfg.infer, tile=TILE, tile_batch=TILE_BATCH)
    whole_cfg = dataclasses.replace(cfg.infer, tile=0, border=-1)
    frame_dev = {k: torch.from_numpy(_mirror_2x2(v)).to("cuda") for k, v in frame["noisy"].items()}
    clean_c = torch.from_numpy(_mirror_2x2(frame["clean"]["combined"])).to("cuda")
    noisy_c = frame_dev["combined"]

    den, grid = pipeline.make_joint_frame_denoiser(cfg.model, tiled_cfg, UHD_H, UHD_W, params)
    if (grid.rows, grid.cols, grid.halo, grid.net_size) != (
            -(-UHD_H // TILE), -(-UHD_W // TILE), (NET_TILE - TILE) // 2, NET_TILE):  # 5 x 8 at 4K
        raise AssertionError(f"{what}: unexpected plan {grid}")
    chunks = -(-grid.n_tiles // TILE_BATCH)
    per_frame = cfg.model.kpn_slots * chunks  # 8 slots x 5 chunks
    res = {"mpx_tiled": grid.n_tiles * NET_TILE**2 / 1e6}
    den(frame_dev)  # builds, cuDNN's algorithm choice
    torch.cuda.synchronize()
    reset_launches()
    den(frame_dev)
    torch.cuda.synchronize()
    launches = read_launches()
    expect_launches(f"{what} tiled frame", launches, kpn_apply=per_frame)
    res["launches"] = launches["kpn_apply"]
    t_tiled, res["peak_tiled"], out = _timed(den, frame_dev, timed_frames, warmup=0)
    check_frame(f"{what} tiled", out, (UHD_H, UHD_W))
    res["gain_tiled"] = _gain_db(out["combined"], noisy_c, clean_c)
    if profile:
        profile_frames(f"{what} tiled", lambda: den(frame_dev), card, frames=2)
    del den, out
    torch.cuda.empty_cache()

    den, wgrid = pipeline.make_joint_frame_denoiser(cfg.model, whole_cfg, UHD_H, UHD_W, params)
    res["mpx_whole"] = wgrid.net_h * wgrid.net_w / 1e6
    reset_launches()
    t_whole, res["peak_whole"], out = _timed(den, frame_dev, timed_frames)
    expect_launches(f"{what} whole frames", read_launches(), timed_frames + 2, kpn_apply=8)
    check_frame(f"{what} whole", out, (UHD_H, UHD_W))
    res["gain_whole"] = _gain_db(out["combined"], noisy_c, clean_c)
    del den, out, frame_dev
    torch.cuda.empty_cache()
    diff = abs(res["gain_tiled"] - res["gain_whole"])
    if min(res["gain_tiled"], res["gain_whole"]) <= 0 or diff > GAIN_TOL_DB:
        raise AssertionError(f"{what}: gain tiled {res['gain_tiled']:.4f} dB vs whole "
                             f"{res['gain_whole']:.4f} dB (limit {GAIN_TOL_DB})")
    res.update(ms_tiled=statistics.median(t_tiled), ms_whole=statistics.median(t_whole))
    log(f"[{what}] 2160x3840 joint frame (the 1080p frame mirrored 2x2), bf16: tiled "
        f"{grid.rows}x{grid.cols} tiles of {NET_TILE} (halo {grid.halo}), {res['mpx_tiled']:.2f} Mpx "
        f"of network input in {chunks} lazy chunks of {TILE_BATCH}: {res['ms_tiled']:.2f} ms/frame "
        f"median of {timed_frames} (min {min(t_tiled):.2f}, max {max(t_tiled):.2f}), peak "
        f"{res['peak_tiled']:.2f} GiB, kpn_apply launches {res['launches']}; whole frame with the "
        f"certified halo, plane {wgrid.net_h}x{wgrid.net_w} = {res['mpx_whole']:.2f} Mpx: "
        f"{res['ms_whole']:.2f} ms/frame (min {min(t_whole):.2f}, max {max(t_whole):.2f}), peak "
        f"{res['peak_whole']:.2f} GiB; host clock around synchronize | {card['smi']}")
    log(f"[{what}] PSNR gain tiled {res['gain_tiled']:.4f} dB, whole {res['gain_whole']:.4f} dB "
        f"(limit {GAIN_TOL_DB} dB apart)")

    # fp32 at 1080p, TF32 off: the tiled frame is the whole frame
    frame_dev = _fp32_frame(frame)
    with full_fp32():
        outs = {}
        for key, icfg in (("whole", whole_cfg), ("tiled", dataclasses.replace(
                tiled_cfg, tile_batch=4))):  # at 1080p 12 tiles in 3 lazy chunks of 4
            icfg = dataclasses.replace(icfg, compute_dtype="float32")
            den, g = pipeline.make_joint_frame_denoiser(cfg.model, icfg, FRAME_H, FRAME_W, params)
            reset_launches()
            outs[key] = den(frame_dev)
            torch.cuda.synchronize()
            expect_launches(f"kpn-hq 1080p fp32 {key}", read_launches(),
                            kpn_apply=8 * -(-g.n_tiles // 4))
            del den
            torch.cuda.empty_cache()
    check_frame("kpn-hq 1080p fp32 tiled", outs["tiled"])
    res["fp32_tiled_vs_whole"] = frames_agree("kpn-hq 1080p fp32, tiled vs whole", outs["tiled"],
                                              outs["whole"], TILED_TOL)
    log(f"[kpn-hq tiled 1080p] fp32 (TF32 off), {g.rows}x{g.cols} tiles of {g.net_size} in lazy "
        f"chunks of 4 vs the whole frame with the certified halo: max over passes of "
        f"max|d|/max|ref| {res['fp32_tiled_vs_whole']:.2e} (limit {TILED_TOL:g})")
    del outs
    torch.cuda.empty_cache()
    return res


def phase_feather(frame: dict, card: dict, timed_frames: int = 3) -> dict:
    """flagship-max (group mode, fused ingest) at 1080p in tiles of 512 run
    in chunks of 8 (batch_dims=1): exact stitching equals the whole frame in
    fp32; the feathered stitch is finite and reported against exact
    stitching (it blends uncertified halo pixels in, so it is close, not
    equal). Returns the launches of one feathered frame."""
    from deepdenoiser_tpu_torch import config, weights_io
    from deepdenoiser_tpu_torch.inference import pipeline

    what = "flagship-max tiled"
    cfg = config.validate_channels(config.PRESETS["flagship-max"])
    params = weights_io.load_release_params(str(ROOT / "weights" / "kpn_ema_f16.npz"))
    base = dataclasses.replace(cfg.infer, use_pallas_ingest=True)
    kinds = {"whole": dataclasses.replace(base, tile=0, border=-1),
             "exact": dataclasses.replace(base, tile=TILE, tile_batch=TILE_BATCH),
             "feather": dataclasses.replace(base, tile=TILE, tile_batch=TILE_BATCH,
                                            stitch="feather")}
    frame_dev = _fp32_frame(frame)
    outs, res = {}, {}
    with full_fp32():
        for key, icfg in kinds.items():
            icfg = dataclasses.replace(icfg, compute_dtype="float32")
            den, grid = pipeline.make_group_frame_denoiser(cfg.model, icfg, FRAME_H, FRAME_W, params)
            chunks = -(-len(LIGHT_GROUPS) * grid.n_tiles // TILE_BATCH) if icfg.tile else 1
            reset_launches()
            outs[key] = den(frame_dev)
            torch.cuda.synchronize()
            launches = read_launches()
            expect_launches(f"{what} fp32 {key}", launches, group_encode=1, kpn_apply=2 * chunks)
            if key == "feather":
                res["launches"] = launches
            check_frame(f"{what} fp32 {key}", outs[key])
            del den
            torch.cuda.empty_cache()
    res["exact_vs_whole"] = frames_agree(f"{what} fp32, exact stitch vs whole", outs["exact"],
                                         outs["whole"], TILED_TOL)
    rel_max, rel_mean = 0.0, 0.0
    for name, r in outs["exact"].items():
        d, scale = (outs["feather"][name] - r).abs(), r.abs().max().clamp_min(1e-30)
        rel_max = max(rel_max, float(d.max() / scale))
        rel_mean = max(rel_mean, float(d.mean() / scale))
    res.update(feather_max=rel_max, feather_mean=rel_mean)
    if rel_max > 0.1 or rel_mean > 2e-3:  # the bar the JAX package's test holds feathering to
        raise AssertionError(f"{what}: feathered stitch strays from exact: max {rel_max:.3e}, "
                             f"mean {rel_mean:.3e} x max|ref|")
    del outs
    torch.cuda.empty_cache()
    den, grid = pipeline.make_group_frame_denoiser(cfg.model, kinds["feather"], FRAME_H, FRAME_W,
                                                   params)
    times, res["peak_gib"], out = _timed(den, frame_dev, timed_frames)
    check_frame(f"{what} bf16 feather", out)
    clean_c, noisy_c = _frame_on_card(frame)
    res["gain_db"] = _gain_db(out["combined"], noisy_c, clean_c)
    if res["gain_db"] <= 0:
        raise AssertionError(f"{what}: no PSNR gain ({res['gain_db']})")
    del den, out
    torch.cuda.empty_cache()
    log(f"[{what}] 1080p group frame, 4 groups x {grid.rows}x{grid.cols} tiles of {grid.net_size} "
        f"(halo {grid.halo}) in chunks of {TILE_BATCH}, fused ingest; fp32 (TF32 off): exact stitch "
        f"vs whole frame max|d|/max|ref| {res['exact_vs_whole']:.2e} (limit {TILED_TOL:g}); "
        f"feathered vs exact stitch max {rel_max:.2e}, mean {rel_mean:.2e} x max|ref| (limits 0.1, "
        f"2e-3); launches per feathered frame {res['launches']}")
    log(f"[{what}] bf16 feathered: {statistics.median(times):.2f} ms/frame median of "
        f"{timed_frames} (min {min(times):.2f}, max {max(times):.2f}; host clock around "
        f"synchronize), peak {res['peak_gib']:.2f} GiB, PSNR gain {res['gain_db']:.4f} dB "
        f"| {card['smi']}")
    return res


def _seeded_params(mcfg):
    """Random parameters from a fixed seed, as the tree the factories take."""
    from deepdenoiser_tpu_torch import weights_io
    from deepdenoiser_tpu_torch.models import factory

    torch.manual_seed(0)
    return weights_io.params_from_state_dict(factory.build_model(mcfg).state_dict())


def phase_multiscale(frame: dict, card: dict, timed_frames: int = 3) -> None:
    """unet-multiscale (3 scales over a shared base-48 UNet): no release
    weights, so seeded random ones, fp32; checked finite, one median."""
    from deepdenoiser_tpu_torch import config
    from deepdenoiser_tpu_torch.inference import pipeline

    cfg = config.validate_channels(config.PRESETS["unet-multiscale"])
    icfg = dataclasses.replace(cfg.infer, compute_dtype="float32")
    den, grid = pipeline.make_joint_frame_denoiser(cfg.model, icfg, FRAME_H, FRAME_W,
                                                   _seeded_params(cfg.model))
    frame_dev = _fp32_frame(frame)
    reset_launches()
    times, peak, out = _timed(den, frame_dev, timed_frames)
    expect_launches("unet-multiscale", read_launches())
    check_frame("unet-multiscale", out)
    log(f"[unet-multiscale] 1080p joint frame, 3 scales, random weights, fp32, plane "
        f"{grid.net_h}x{grid.net_w} (halo {grid.halo}): finite; {statistics.median(times):.2f} "
        f"ms/frame median of {timed_frames} (min {min(times):.2f}, max {max(times):.2f}), peak "
        f"{peak:.2f} GiB | {card['smi']}")
    del den, out
    torch.cuda.empty_cache()


def phase_flags(frame: dict, card: dict) -> None:
    """The flagship-flags model (45 input channels, random weights) on the
    frame with its subsurface group taken out."""
    from deepdenoiser_tpu_torch import config, transforms
    from deepdenoiser_tpu_torch.inference import pipeline

    cfg = config.validate_channels(config.PRESETS["flagship-flags"])
    if cfg.model.in_channels != 45 or not cfg.data.use_flags:
        raise AssertionError(f"flagship-flags: unexpected config {cfg}")
    den, grid = pipeline.make_joint_frame_denoiser(
        cfg.model, cfg.infer, FRAME_H, FRAME_W, _seeded_params(cfg.model),
        groups=tuple(cfg.data.groups), use_flags=True)
    frame_dev = {k: v for k, v in _fp32_frame(frame).items() if not k.startswith("subsurface_")}
    out = den(frame_dev)
    torch.cuda.synchronize()
    check_frame("flagship-flags", out)
    present = tuple(g for g in LIGHT_GROUPS if g != "subsurface")
    extra = [k for k in out if k.startswith("subsurface_")]
    missing = [f"{g}_{part}" for g in present for part in ("direct", "indirect", "color")
               if f"{g}_{part}" not in out]
    if extra or missing:
        raise AssertionError(f"flagship-flags: passes {sorted(out)}: extra {extra}, missing {missing}")
    rec = transforms.recompose({k: v for k, v in out.items() if k != "combined"}, present)
    rel = float((rec - out["combined"]).abs().max() / out["combined"].abs().max())
    if not rel <= 1e-6:
        raise AssertionError(f"flagship-flags: combined differs from recompose by {rel:.3e}")
    log(f"[flagship-flags] 1080p joint frame without the subsurface group, 45 input channels, "
        f"random weights, plane {grid.net_h}x{grid.net_w}: {len(out)} passes out, none of "
        f"subsurface; combined == recompose of {len(present)} groups (max|d|/max|ref| {rel:.1e}) "
        f"| {card['smi']}")
    del den, out
    torch.cuda.empty_cache()


SEQUENCE_KEYS = {"n_frames", "height", "width", "grid", "latency_ms", "latency_ms_mean",
                 "latency_ms_median", "fetch_overhead_ms", "psnr", "psnr_mean", "ssim", "ssim_mean"}


def _check_report(what: str, report: dict, n: int, hw) -> None:
    vals = [*report["psnr"], *report["ssim"], *report["latency_ms"], report["latency_ms_mean"]]
    if (set(report) != SEQUENCE_KEYS or report["n_frames"] != n
            or (report["height"], report["width"]) != tuple(hw)
            or not all(math.isfinite(v) for v in vals)
            or not all(0 < v <= 1 for v in report["ssim"]) or min(report["psnr"]) <= 0):
        raise AssertionError(f"{what}: bad report {report}")


def phase_sequence(frame: dict, card: dict, n_frames: int = 4) -> dict:
    """The sequence harness over `n_frames` noisy renders of the 1080p frame
    with flagship-hq, PSNR and SSIM computed on the card; then the `eval`
    command over a small render root in a temporary directory."""
    import io

    import numpy as np

    from deepdenoiser_tpu_torch import cli, config, weights_io
    from deepdenoiser_tpu_torch.data import exr, synthetic
    from deepdenoiser_tpu_torch.data.prepare import GT_DIR
    from deepdenoiser_tpu_torch.inference import sequence
    from deepdenoiser_tpu_torch.ops import metrics

    wpath = str(ROOT / "weights" / "flagship_hq_ema_f16.npz")
    cfg = config.validate_channels(config.PRESETS["flagship-hq"])
    clean = frame["clean"]
    frames = [frame["noisy"]] + [synthetic.add_mc_noise(clean, spp=4, seed=1 + i)
                                 for i in range(1, n_frames)]
    frames = [{k: np.asarray(v, np.float32) for k, v in f.items()} for f in frames]
    gts = [np.asarray(clean["combined"], np.float32)] * n_frames
    reset_launches()
    report = sequence.run_sequence(cfg.model, cfg.infer, weights_io.load_release_params(wpath),
                                   frames, gts, mode="joint")
    expect_launches("sequence", read_launches())
    _check_report("run_sequence", report, n_frames, (FRAME_H, FRAME_W))
    tm = metrics.tonemap_for_metrics
    ref = tm(torch.from_numpy(gts[0]).to("cuda"))[None]
    noisy_t = tm(torch.from_numpy(frames[0]["combined"]).to("cuda"))[None]
    noisy_psnr = float(metrics.psnr_per_image(noisy_t, ref)[0])
    noisy_ssim = float(metrics.ssim(noisy_t, ref)[0])
    if report["psnr"][0] <= noisy_psnr or report["ssim"][0] <= noisy_ssim:
        raise AssertionError(f"run_sequence: no gain over the noisy frame: {report}")
    ssim_ms = cuda_ms(lambda: metrics.ssim(noisy_t, ref), iters=10)
    log(f"[sequence] run_sequence, flagship-hq, {n_frames} noisy renders of the 1080p frame: "
        f"latency_ms {', '.join(f'{t:.2f}' for t in report['latency_ms'])} (median "
        f"{report['latency_ms_median']:.2f}; each frame closed by a synchronize), latency_ms_mean "
        f"{report['latency_ms_mean']:.2f} (all frames, one synchronize), fetch_overhead_ms "
        f"{report['fetch_overhead_ms']:.3f}; PSNR {report['psnr_mean']:.4f} dB (noisy "
        f"{noisy_psnr:.4f}), SSIM {report['ssim_mean']:.5f} (noisy {noisy_ssim:.5f}); ssim alone "
        f"{ssim_ms:.3f} ms (CUDA events around 10 calls) | {card['smi']}")

    h, w = 270, 480
    with tempfile.TemporaryDirectory(dir=WORK) as tmp:
        for i in range(2):
            c = synthetic.generate_clean_passes(h, w, seed=10 + i)
            fd = Path(tmp) / f"frame{i:04d}"
            exr.save_frame_dir(fd / GT_DIR, c)
            exr.save_frame_dir(fd / "spp4_seed0", synthetic.add_mc_noise(c, spp=4, seed=20 + i))
            exr.save_frame_dir(fd / "spp16_seed0", synthetic.add_mc_noise(c, spp=16, seed=30 + i))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["eval", "--preset", "flagship-hq", "--weights", wpath,
                           "--renders", tmp])
    if rc != 0:
        raise AssertionError(f"cli eval returned {rc}")
    ev = json.loads(buf.getvalue())
    _check_report("cli eval", ev, 2, (h, w))
    log(f"[eval] deepdenoiser-torch eval, flagship-hq, 2 frames of {h}x{w} (spp4 scored, spp16 "
        f"beside it): PSNR {ev['psnr_mean']:.4f} dB, SSIM {ev['ssim_mean']:.5f}, latency median "
        f"{ev['latency_ms_median']:.2f} ms")
    torch.cuda.empty_cache()
    return report


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_CROP = 16, 96  # the JAX package's recipe (tools/pretrain_flagship.py)
TRAIN_STEPS, RESUME_STEPS = 20, 30  # the first `train` call, and the resumed one
TRAIN_WARMUP = 5  # steps left out of the per-step medians
# the fixed-batch overfit check runs kpn-hq OVERFIT_STEPS steps (loss at
# 30 steps read 0.484x the first; 100 leave the 0.5x bar a margin);
# flagship-hq, which diverges at this lr, is timed over TIMED_STEPS
OVERFIT_STEPS, TIMED_STEPS, OVERFIT_LR = 100, 30, 1e-3
LOADER_BATCHES = 20  # batches timed for the loader alone and for fit's loop split
BWD_REPLACES = "deepdenoiser_tpu/ops/kpn_pallas.py:158"
BWD_ENTRIES = {"bwd_weights": "kpn_apply_bwd_weights_f32", "bwd_noisy": "kpn_apply_bwd_noisy_f32"}


def _bwd_work(shape, k) -> tuple:
    """(bytes, operations) of one backward entry point: C + C + k*k floats
    per pixel read or written once (noisy + g in, d_w out; or g + w in,
    d_noisy out), and C*k*k multiply-adds."""
    n, h, w, c = shape
    px = n * h * w
    return px * (2 * c + k * k) * 4, px * c * k * k * 2


def _bwd_inputs(shape, k, gen):
    """noisy, weights, g on the card as training hands them to the
    backward: with C=3 the noisy slot is a 3-channel slice of the
    41-channel fp32 input and g a 3-channel range of the 24-channel output
    gradient; the weights a permuted view of planar softmax output."""
    n, h, w, c = shape
    dev = "cuda"
    if c == 3:
        noisy = torch.rand((n, h, w, 41), generator=gen, device=dev)[..., 9:12]
        g = torch.randn((n, h, w, 24), generator=gen, device=dev)[..., 3:6]
    else:
        noisy = torch.rand(shape, generator=gen, device=dev)
        g = torch.randn(shape, generator=gen, device=dev)
    logits = torch.randn((n, k * k, h, w), generator=gen, device=dev)
    return noisy, torch.softmax(logits, dim=1).permute(0, 2, 3, 1), g


def phase_train_kernels(card: dict) -> dict:
    """K1's two backward entry points against the plain backward at the
    training shape, the joint 1080p plane, and k=3 / C=1 and C=4; device
    time of each at the first two shapes by CUDA-graph replay over buffer
    sets larger than the L2, in turns. Returns entry -> timing at the
    training shape, with the plane's under "plane"."""
    from deepdenoiser_tpu_torch.models import kpn
    from deepdenoiser_tpu_torch.ops import kpn_apply

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    cases = [((TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 3), 5, "train"),
             ((1, PLANE_H, PLANE_W, 3), 5, "plane"),
             ((2, 130, 170, 1), 3, None), ((1, 37, 53, 4), 5, None), ((3, 61, 45, 4), 3, None)]
    worst = {e: 0.0 for e in BWD_ENTRIES}
    timings = {e: {} for e in BWD_ENTRIES}
    for shape, k, path in cases:
        noisy, weights, g = _bwd_inputs(shape, k, gen)
        got = {"bwd_weights": kpn_apply.bwd_weights_cuda(noisy, g, k),
               "bwd_noisy": kpn_apply.bwd_noisy_cuda(g, weights, k)}
        ref_n, ref_w = kpn.apply_per_pixel_kernels_bwd(noisy, weights, g, k, True)
        torch.cuda.synchronize()
        errs = []
        for entry, ref in (("bwd_weights", ref_w), ("bwd_noisy", ref_n)):
            err = (got[entry] - ref).abs()
            bad = int((err > TOL_ABS + TOL_REL * ref.abs()).sum())
            worst[entry] = max(worst[entry], float(err.max()))
            errs.append(f"{entry} max|d|={float(err.max()):.3e} over tolerance={bad}")
            if bad or not torch.isfinite(got[entry]).all():
                raise AssertionError(f"kpn_apply.{entry} disagrees with the plain backward at "
                                     f"{shape} k={k}")
        log(f"[train-kernels] {shape} k={k}: " + "; ".join(errs))
        del noisy, weights, g, got, ref_n, ref_w
        if path is None:
            continue
        nbytes, flops = _bwd_work(shape, k)
        sets = max(2, min(16, math.ceil(4 * H100_L2_BYTES / nbytes)))
        bufs = [_bwd_inputs(shape, k, gen) for _ in range(sets)]
        calls = {"bwd_weights": [lambda b=b: kpn_apply.bwd_weights_cuda(b[0], b[2], k) for b in bufs],
                 "bwd_noisy": [lambda b=b: kpn_apply.bwd_noisy_cuda(b[2], b[1], k) for b in bufs]}
        plain = {"bwd_weights": [lambda b=b: kpn.apply_per_pixel_kernels_bwd(*b, k, False)
                                 for b in bufs],
                 "bwd_noisy": [lambda b=b: kpn.apply_per_pixel_kernels_bwd(*b, k, True)
                               for b in bufs]}
        w1, n1 = graph_ms(calls["bwd_weights"]), graph_ms(calls["bwd_noisy"])
        n2, w2 = graph_ms(calls["bwd_noisy"]), graph_ms(calls["bwd_weights"])
        ms = {"bwd_weights": (w1 + w2) / 2, "bwd_noisy": (n1 + n2) / 2}
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        ops_ms = flops / H100_FP32_FLOP_PER_S * 1e3
        for entry in BWD_ENTRIES:
            plain_ms = graph_ms(plain[entry], replays=3)
            eager_ms = cuda_ms(rotating(calls[entry]), iters=20 * sets)
            timings[entry][path] = {
                "shape": list(shape), "k": k, "ms": ms[entry], "plain_ms": plain_ms,
                "eager_ms": eager_ms, "library_ms": None,  # no single PyTorch call computes it
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "flops": flops, "buffer_sets": sets,
            }
            log(f"[train-kernels] kpn_apply.{entry} {shape} k={k} ({path}): "
                f"{ms[entry] * 1e3:.1f} us/launch ({nbytes / (ms[entry] * 1e-3) / 1e12:.2f} TB/s); "
                f"bound {timings[entry][path]['bound_ms'] * 1e3:.1f} us by "
                f"{timings[entry][path]['bound_by']} ({nbytes / 1e6:.1f} MB at 3.35 TB/s = "
                f"{bytes_ms * 1e3:.1f} us, {flops / 1e9:.3f} GFLOP at 67 TFLOP/s = "
                f"{ops_ms * 1e3:.1f} us); plain backward "
                + ("(d_w only)" if entry == "bwd_weights" else "(both gradients)")
                + f" {plain_ms * 1e3:.1f} us; eager call {eager_ms * 1e3:.1f} us; CUDA-graph "
                f"replay over {sets} buffer sets, in turns | {card['smi']}")
        del bufs, calls, plain
        torch.cuda.empty_cache()
    return {e: {**t["train"], "plane": t["plane"], "max_abs_err": worst[e]}
            for e, t in timings.items()}


def phase_train_parity(card: dict) -> None:
    """One make_train_step step of a small joint KPN (base 16, depth 2, 8
    slots, fp32) on the card against the same step on the CPU, from the
    same initial state and batch, TF32 off."""
    from deepdenoiser_tpu_torch import config
    from deepdenoiser_tpu_torch.models.factory import ModelConfig
    from deepdenoiser_tpu_torch.training import train as train_lib

    mcfg = ModelConfig(backbone="unet", in_channels=41, out_channels=24, base_width=16, depth=2,
                       kernel_prediction=True, kpn_size=5, kpn_slots=8, kpn_logit_norm=True,
                       act="leaky_relu")
    lr = 1e-3
    tcfg = config.TrainConfig(learning_rate=lr, warmup_steps=0, schedule="constant",
                              ema_decay=0.999)
    gen = torch.Generator().manual_seed(3)
    x = torch.rand((4, 64, 64, 41), generator=gen)
    sig = torch.cat([x[..., 9 * g : 9 * g + 6] for g in range(4)], dim=-1)
    batch = {"x": x, "y": sig + 0.05 * torch.randn(sig.shape, generator=gen)}
    step = train_lib.make_train_step(mcfg, tcfg)
    with full_fp32():
        gpu = train_lib.create_state(mcfg, tcfg, seed=0)
        reset_launches()
        gpu, gm = step(gpu, {k: v.to("cuda") for k, v in batch.items()})
        torch.cuda.synchronize()
        expect_launches("train-parity step", read_launches(), kpn_apply=8, kpn_apply_bwd_weights=8)
    cpu = train_lib.create_state(mcfg, tcfg, seed=0, device="cpu")
    cpu, cm = step(cpu, batch)
    rel = {k: abs(float(gm[k]) - float(cm[k])) / abs(float(cm[k])) for k in ("loss", "grad_norm")}
    diffs = torch.cat([(gpu.params[n].detach().cpu() - p.detach()).abs().flatten()
                       for n, p in cpu.params.items()])
    grads = torch.cat([p.grad.abs().flatten() for p in cpu.params.values()])
    ema = max(float((gpu.ema_params[n].cpu() - e).abs().max()) for n, e in cpu.ema_params.items())
    # Adam's first update moves every element by lr*g/(|g|+1e-8), about lr
    # whatever |g| is, so an element stays within 2 lr in any case; two runs
    # part by more than 1e-3 lr only where the gradient is at the level of
    # the card's and the CPU's rounding (cuDNN sums in other orders), which
    # the bar puts at 1e-5 of the gradient's global norm
    far = diffs > 1e-3 * lr
    noise = 1e-5 * float(cm["grad_norm"])
    far_grad = float(grads[far].max()) if far.any() else 0.0
    log(f"[train-parity] joint KPN base 16 depth 2, 8 slots, fp32 (TF32 off), batch (4,64,64,41), "
        f"Adam lr {lr} constant: loss {float(gm['loss']):.7f} card / {float(cm['loss']):.7f} CPU "
        f"(rel {rel['loss']:.2e}), grad_norm {float(gm['grad_norm']):.7f} / "
        f"{float(cm['grad_norm']):.7f} (rel {rel['grad_norm']:.2e}); parameters after the step: "
        f"max|d| {float(diffs.max()):.3e} = {float(diffs.max()) / lr:.2e} lr, mean "
        f"{float(diffs.mean()):.3e}; {int(far.sum())} of {diffs.numel()} elements beyond 1e-3 lr, "
        f"their largest |gradient| {far_grad:.2e} (bar {noise:.2e}); EMA max|d| {ema:.3e}; "
        f"launches 8 forward, 8 bwd_weights, 0 bwd_noisy | {card['smi']}")
    if not (rel["loss"] <= 1e-5 and rel["grad_norm"] <= 1e-5):
        raise AssertionError(f"train-parity: loss / grad_norm differ by {rel}")
    if not (float(diffs.max()) <= 2 * lr and far_grad <= noise):
        raise AssertionError(f"train-parity: parameters differ by max {float(diffs.max())}; "
                             f"elements beyond 1e-3 lr have gradients up to {far_grad}")


def _train_config():
    """kpn-hq at the JAX package's training recipe: batch 16, crop 96,
    warm-up 10, lr 2.5e-4 (the kpn-hq recipe); a small corpus: 8 crops per
    frame, one frame in five for validation; a log line per step."""
    from deepdenoiser_tpu_torch import config

    cfg = config.PRESETS["kpn-hq"]
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, batch_size=TRAIN_BATCH, crop=TRAIN_CROP,
                                 crops_per_frame=8, validation_fraction=0.2),
        train=dataclasses.replace(cfg.train, learning_rate=2.5e-4, warmup_steps=10,
                                  steps=RESUME_STEPS, log_every=1, checkpoint_every=10,
                                  eval_every=TRAIN_STEPS),
    )


def _metrics(path: Path) -> list:
    return [json.loads(ln) for ln in path.read_text().splitlines() if ln.strip()]


def _cli_quiet(argv) -> int:
    """cli.main with its per-step stdout kept out of the log."""
    import io

    from deepdenoiser_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        return cli.main(argv)


def _steps_timed(state, step, batch, n: int) -> tuple:
    """(losses, host-clock ms of each step closed by reading its loss)."""
    losses, times = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        state, mets = step(state, batch)
        losses.append(float(mets["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    return losses, times


def _loader_and_loop_split(cfg, shards_dir: Path, card: dict) -> dict:
    """Where a `train` step's time goes: the loader alone (its threads,
    pinned batches, as fit starts it); fit's loop body as fit runs it
    (next, to the card, encode, step, the metric record; no synchronize
    but the record's read); and the same body with each part closed by a
    synchronize: next(), to the card and encode, the step, the record."""
    from deepdenoiser_tpu_torch import config
    from deepdenoiser_tpu_torch.data import loader
    from deepdenoiser_tpu_torch.training import loop
    from deepdenoiser_tpu_torch.training import train as train_lib

    source = loader.make_dataset(shards_dir / "train", cfg.data)
    source.batch(0, 0)  # reads the shard into the reader's cache
    t0 = time.perf_counter()
    for b in range(1, 4):
        source.batch(0, b % source.batches_per_epoch)
    one_ms = (time.perf_counter() - t0) / 3 * 1e3
    it = loader.make_iterator(shards_dir / "train", cfg.data, pin_memory=True)
    for _ in range(it.prefetch):  # the shard is read and the pinned blocks cached
        next(it)
    t0 = time.perf_counter()
    for _ in range(LOADER_BATCHES):
        next(it)
    loader_ms = (time.perf_counter() - t0) / LOADER_BATCHES * 1e3
    it.close()
    mcfg = config.validate_channels(cfg).model
    state = train_lib.create_state(mcfg, cfg.train, seed=0)
    step = train_lib.make_train_step(mcfg, cfg.train)
    encode = loader.make_batch_encoder(cfg.data)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(dir=WORK) as logdir, \
            contextlib.redirect_stdout(io.StringIO()):
        logger = loop.MetricLogger(Path(logdir))
        it = loader.make_iterator(shards_dir / "train", cfg.data, pin_memory=True)
        whole = []
        for i in range(TRAIN_WARMUP + LOADER_BATCHES):
            t0 = time.perf_counter()
            state, mets = step(state, encode(loop._to_device(next(it), dev)))
            logger.log(i, mets)
            if i >= TRAIN_WARMUP:
                whole.append((time.perf_counter() - t0) * 1e3)
        parts = {"next": [], "encode": [], "step": [], "record": []}
        for i in range(TRAIN_WARMUP + LOADER_BATCHES):
            t0 = time.perf_counter()
            raw = next(it)
            t1 = time.perf_counter()
            batch = encode(loop._to_device(raw, dev))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            state, mets = step(state, batch)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            logger.log(i, mets)
            t4 = time.perf_counter()
            if i >= TRAIN_WARMUP:
                for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                    parts[k].append(dt * 1e3)
        it.close()
        logger.close()
    med = {k: statistics.median(v) for k, v in parts.items()}
    whole_ms = statistics.median(whole)
    log(f"[train] one batch built in this process (reads, D4, stack): {one_ms:.2f} ms; the "
        f"loader alone: {loader_ms:.2f} ms/batch over {LOADER_BATCHES} batches ({it.threads} "
        f"threads, pinned; host: {os.cpu_count()} CPUs, {len(os.sched_getaffinity(0))} usable); "
        f"fit's loop body as fit runs it: {whole_ms:.2f} ms/step, median of {LOADER_BATCHES}; "
        f"with each part closed by a synchronize: next() {med['next']:.2f} ms, to the card + "
        f"encode {med['encode']:.2f} ms, step {med['step']:.2f} ms, metric record "
        f"{med['record']:.2f} ms (sum {sum(med.values()):.2f}; tensorboard "
        f"{'on' if logger._tb is not None else 'not installed'}) | {card['smi']}")
    del state, step
    torch.cuda.empty_cache()
    return {"loader_ms": loader_ms, "one_batch_ms": one_ms, "loop_ms": med,
            "loop_whole_ms": whole_ms}


@contextlib.contextmanager
def _k1_in_eval(counts: dict):
    """Counts K1's launches inside fit's eval and preview into
    counts['kpn_apply'], so a `train` call's launches split into its
    steps' and its eval's."""
    from deepdenoiser_tpu_torch.ops import kpn_apply
    from deepdenoiser_tpu_torch.training import loop

    def counted(fn):
        def run(*args, **kwargs):
            before = kpn_apply.launches
            try:
                return fn(*args, **kwargs)
            finally:
                counts["kpn_apply"] += kpn_apply.launches - before
        return run

    saved = loop._run_eval, loop._log_preview
    loop._run_eval, loop._log_preview = counted(saved[0]), counted(saved[1])
    try:
        yield counts
    finally:
        loop._run_eval, loop._log_preview = saved


def phase_train(frame: dict, card: dict, profile: bool = False) -> dict:
    """kpn-hq trained through the user's commands: synth-data -> prepare-data
    -> train (20 steps, then resumed to 30) -> denoise --checkpoint --ema on
    the 1080p frame; then a fixed-batch overfit check and ms per step of
    kpn-hq and flagship-hq through make_train_step."""
    import shutil

    from deepdenoiser_tpu_torch import config
    from deepdenoiser_tpu_torch.data import exr, loader
    from deepdenoiser_tpu_torch.training import train as train_lib

    renders, shards_dir, workdir = WORK / "train_renders", WORK / "train_shards", WORK / "train_run"
    for d in (renders, shards_dir, workdir):
        shutil.rmtree(d, ignore_errors=True)
    cfg = _train_config()
    cfg_path = WORK / "train.json"
    config.save(cfg, cfg_path)
    res = {}

    t0 = time.perf_counter()
    if _cli_quiet(["synth-data", "--out", str(renders), "--frames", "4", "--size", "192"]) != 0:
        raise AssertionError("cli synth-data failed")
    t_synth = time.perf_counter() - t0
    t0 = time.perf_counter()
    if _cli_quiet(["prepare-data", "--config", str(cfg_path), "--renders", str(renders),
                   "--out", str(shards_dir)]) != 0:
        raise AssertionError("cli prepare-data failed")
    t_prep = time.perf_counter() - t0
    n_train = loader.make_dataset(shards_dir / "train", cfg.data).n_examples
    n_val_batches = loader.make_dataset(shards_dir / "validation", cfg.data,
                                        training=False).batches_per_epoch
    log(f"[train] synth-data: 4 Fourier frames of 192x192, spp 4 and 16, in {t_synth:.1f} s; "
        f"prepare-data: {n_train} training crops of {TRAIN_CROP}, {n_val_batches} validation "
        f"batch(es), in {t_prep:.1f} s")

    train_argv = ["train", "--config", str(cfg_path), "--workdir", str(workdir),
                  "--shards", str(shards_dir)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with _k1_in_eval({"kpn_apply": 0}) as in_eval:
        if _cli_quiet([*train_argv, "--steps", str(TRAIN_STEPS)]) != 0:
            raise AssertionError("cli train failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    res["launches"] = read_launches()
    # K1 in the steps: the call's count less the eval's, counted apart
    res["k1_eval_launches"] = in_eval["kpn_apply"]
    res["k1_step_launches"] = res["launches"]["kpn_apply"] - in_eval["kpn_apply"]
    per_eval = 8 * (2 * n_val_batches + 1)  # params + EMA per batch, and the preview
    if (res["k1_step_launches"], res["k1_eval_launches"]) != (8 * TRAIN_STEPS, per_eval):
        raise AssertionError(f"cli train: K1 launches {res['k1_step_launches']} in the steps, "
                             f"{res['k1_eval_launches']} in the eval; want {8 * TRAIN_STEPS}, "
                             f"{per_eval}")
    expect_launches("cli train", res["launches"], kpn_apply=8 * TRAIN_STEPS + per_eval,
                    kpn_apply_bwd_weights=8 * TRAIN_STEPS)
    recs = _metrics(workdir / "metrics_train.jsonl")
    if [r["step"] for r in recs] != list(range(1, TRAIN_STEPS + 1)) or not all(
            math.isfinite(r["loss"]) for r in recs):
        raise AssertionError(f"cli train: metrics {recs}")
    evals = _metrics(workdir / "metrics_eval.jsonl")
    if [r["step"] for r in evals] != [TRAIN_STEPS] or not (
            workdir / "previews" / f"step_{TRAIN_STEPS:08d}.png").exists():
        raise AssertionError(f"cli train: eval records {evals}")
    step_ms = [(b["time"] - a["time"]) * 1e3 for a, b in zip(recs[TRAIN_WARMUP:], recs[TRAIN_WARMUP + 1:])]
    res["cli_ms"] = statistics.median(step_ms)
    res["cli_peak_gib"] = peak
    px = TRAIN_BATCH * TRAIN_CROP * TRAIN_CROP
    log(f"[train] cli train, kpn-hq, batch {TRAIN_BATCH}, crop {TRAIN_CROP}, bf16, {TRAIN_STEPS} "
        f"steps in {wall:.1f} s (loader threads, eval and checkpoints included): "
        f"{res['cli_ms']:.2f} ms/step median over steps {TRAIN_WARMUP + 2}-{TRAIN_STEPS} (host "
        f"clock between metric records, each closed by reading the step's metrics), "
        f"{TRAIN_BATCH / res['cli_ms'] * 1e3:.1f} samples/s, {px / res['cli_ms'] / 1e3:.2f} Mpx/s, "
        f"peak {peak:.2f} GiB; launches: kpn_apply {res['k1_step_launches']} in the steps + "
        f"{res['k1_eval_launches']} in the eval at step {TRAIN_STEPS}, bwd_weights "
        f"{res['launches']['kpn_apply_bwd_weights']}, bwd_noisy "
        f"{res['launches']['kpn_apply_bwd_noisy']} | {card['smi']}")
    e = evals[0]
    log(f"[train] eval at step {TRAIN_STEPS}: psnr_tm {e['psnr_tm']:.4f} dB (EMA "
        f"{e['ema_psnr_tm']:.4f}, noisy {e['noisy_psnr_tm']:.4f}), ssim_tm {e['ssim_tm']:.5f}")

    reset_launches()
    if _cli_quiet([*train_argv, "--steps", str(RESUME_STEPS)]) != 0:
        raise AssertionError("cli train (resume) failed")
    torch.cuda.synchronize()
    resumed = RESUME_STEPS - TRAIN_STEPS
    expect_launches("cli train resumed", read_launches(), kpn_apply=8 * resumed,
                    kpn_apply_bwd_weights=8 * resumed)
    recs = _metrics(workdir / "metrics_train.jsonl")
    ckpts = sorted(int(p.name) for p in (workdir / "checkpoints").iterdir() if p.name.isdigit())
    if [r["step"] for r in recs] != list(range(1, RESUME_STEPS + 1)) or ckpts != [10, 20, 30]:
        raise AssertionError(f"cli train resume: steps {[r['step'] for r in recs]}, "
                             f"checkpoints {ckpts}")
    log(f"[train] resumed at step {TRAIN_STEPS} to {RESUME_STEPS}: metrics file continues; "
        f"checkpoints {ckpts}; loss curve "
        + " ".join(f"{r['loss']:.4f}" for r in recs))

    reset_launches()
    out_exr = WORK / "train_denoised.exr"
    if _cli_quiet(["denoise", "--config", str(workdir / "config.json"), "--checkpoint",
                   str(workdir / "checkpoints"), "--ema", "--frame", str(frame["dir"]),
                   "--out", str(out_exr)]) != 0:
        raise AssertionError("cli denoise --checkpoint failed")
    torch.cuda.synchronize()
    expect_launches("cli denoise --checkpoint", read_launches(), kpn_apply=8)
    out = torch.from_numpy(exr.read_exr(out_exr))
    if tuple(out.shape) != (FRAME_H, FRAME_W, 3) or not torch.isfinite(out).all():
        raise AssertionError(f"cli denoise --checkpoint: output {tuple(out.shape)} not finite")
    log(f"[train] denoise --checkpoint --ema (step {RESUME_STEPS}): 1080p frame finite, 8 "
        f"kpn_apply launches")

    res.update(_loader_and_loop_split(cfg, shards_dir, card))

    # ms per step through make_train_step on a batch already on the card,
    # kpn-hq and flagship-hq at the same batch and crop; kpn-hq's run is
    # also the fixed-batch overfit check
    raw = {k: v.to("cuda") for k, v in loader.make_dataset(shards_dir / "train", cfg.data,
                                                           training=False)[(0, 0)].items()}
    batch = loader.make_batch_encoder(cfg.data)(raw)
    for preset, k1, n in (("kpn-hq", 8, OVERFIT_STEPS), ("flagship-hq", 0, TIMED_STEPS)):
        mcfg = config.validate_channels(config.PRESETS[preset]).model
        tcfg = dataclasses.replace(cfg.train, learning_rate=OVERFIT_LR, warmup_steps=0,
                                   schedule="constant")
        state = train_lib.create_state(mcfg, tcfg, seed=0)
        step = train_lib.make_train_step(mcfg, tcfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses, times = _steps_timed(state, step, batch, n)
        expect_launches(f"{preset} train steps", read_launches(), n, kpn_apply=k1,
                        kpn_apply_bwd_weights=k1)
        ms = statistics.median(times[TRAIN_WARMUP:])
        res[preset] = {"ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                       "first_loss": losses[0], "last_loss": losses[-1], "steps": n}
        log(f"[train] {preset} make_train_step, batch {TRAIN_BATCH}, crop {TRAIN_CROP}, bf16, one "
            f"fixed batch on the card, Adam lr {OVERFIT_LR} constant: {ms:.2f} ms/step median of "
            f"{n - TRAIN_WARMUP} (min {min(times[TRAIN_WARMUP:]):.2f}, max "
            f"{max(times[TRAIN_WARMUP:]):.2f}; host clock, each step closed by reading its loss), "
            f"{TRAIN_BATCH / ms * 1e3:.1f} samples/s, {px / ms / 1e3:.2f} Mpx/s, peak "
            f"{res[preset]['peak_gib']:.2f} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f} "
            f"({losses[-1] / losses[0]:.3f}x; at step 30 {losses[29] / losses[0]:.3f}x); K1 launches per step {k1} forward, {k1} backward "
            f"| {card['smi']}")
        log(f"[train] {preset} fixed-batch loss curve: " + " ".join(f"{v:.4f}" for v in losses))
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{preset}: non-finite loss {losses}")
        if preset == "kpn-hq" and not losses[-1] < 0.5 * losses[0]:
            raise AssertionError(f"kpn-hq overfit: loss {losses[0]} -> {losses[-1]}, not below half")
        if profile:
            profile_frames(f"{preset} train step", lambda: step(state, batch), card)
        del state, step
        torch.cuda.empty_cache()
    return res


def _kernel_row(name: str, source: str, replaces: str, launches: int, t: dict,
                on_path: bool = True, **extra) -> dict:
    """One entry of the kernels line; `on_path`: some entry point's path
    launches the kernel (else it is only held to its plain version)."""
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "on_path": on_path, "max_abs_err": t["max_abs_err"], "ms": t["ms"],
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
    uhd_res = phase_tiled_4k(frame, card, profile=args.profile)
    feather_res = phase_feather(frame, card)
    for preset in ("tiramisu-lt1", "tiramisu-fast", "tiramisu"):
        phase_preset(preset, preset.replace("-", "_") + "_ema_f16.npz", frame, card,
                     kernel_launches_per_frame=0, check_fp32=True,
                     profile=args.profile and preset == "tiramisu-lt1", timed_frames=5,
                     gain_tol=TIRAMISU_GAIN_TOL_DB)
    phase_multiscale(frame, card)
    phase_flags(frame, card)
    phase_sequence(frame, card)
    train_kern = phase_train_kernels(card)
    phase_train_parity(card)
    train_res = phase_train(frame, card, profile=args.profile)

    group, tile = kern["group"], kern["tile"]
    kernels = [_kernel_row(
        "kpn_apply", "deepdenoiser_tpu_torch/csrc/kpn_apply.cu",
        "deepdenoiser_tpu/ops/kpn_pallas.py:59", kpn_res["cli_launches"], kern,
        launches_per_frame=kpn_res["launches_per_frame"], k=kern["k"],
        launches_group_frame=max_res["cli_launches"]["kpn_apply"],
        group_shape=group["shape"], group_ms=group["ms"], group_plain_ms=group["plain_ms"],
        group_bound_ms=group["bound_ms"],
        launches_tiled_4k_frame=uhd_res["launches"],
        launches_feathered_group_frame=feather_res["launches"]["kpn_apply"],
        tile_shape=tile["shape"], tile_ms=tile["ms"], tile_plain_ms=tile["plain_ms"],
        tile_bound_ms=tile["bound_ms"], tile_bytes=tile["bytes"],
        launches_per_train_step=train_res["k1_step_launches"] / TRAIN_STEPS,
        launches_train_eval=train_res["k1_eval_launches"],
    )]
    for entry, fn in BWD_ENTRIES.items():
        t, plane = train_kern[entry], train_kern[entry]["plane"]
        # launches: of the first `train` call (20 steps, its eval runs no
        # backward); d_noisy has no caller on any entry point (training's
        # signal is a slice of the network input): KpnApply needs it for the
        # signal's gradient, and it is held to the plain backward only
        kernels.append(_kernel_row(
            f"kpn_apply.{entry}", "deepdenoiser_tpu_torch/csrc/kpn_apply_bwd.cu", BWD_REPLACES,
            train_res["launches"][f"kpn_apply_{entry}"], t, on_path=entry != "bwd_noisy",
            k=t["k"], entry_point=fn,
            launches_per_train_step=train_res["launches"][f"kpn_apply_{entry}"] / TRAIN_STEPS,
            eager_ms=t["eager_ms"], buffer_sets=t["buffer_sets"],
            plane_shape=plane["shape"], plane_ms=plane["ms"], plane_plain_ms=plane["plain_ms"],
            plane_bound_ms=plane["bound_ms"], plane_bytes=plane["bytes"],
        ))
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
        launches_by_path={"flagship-max": max_res["cli_launches"]["group_encode"], **aux_counts,
                          "flagship-max feathered": feather_res["launches"]["group_encode"]},
        bodies_by_path={path: [ingest[b]["replaces"] for b in bodies]
                        for path, bodies in GROUP_ENCODE_BODIES.items()},
    ))
    idle = [k["name"] for k in kernels if k["launches"] < 1 and k["on_path"]]
    if idle:
        raise AssertionError(f"kernels launched on no path: {idle}")
    log(f"[done] all phases in {time.perf_counter() - t_start:.0f} s")
    log("[summary] train ms/step: kpn-hq cli {:.2f} (loader included), fit's loop body {:.2f}, "
        "make_train_step {:.2f}; flagship-hq make_train_step {:.2f}; loader alone {:.2f} "
        "ms/batch".format(train_res["cli_ms"], train_res["loop_whole_ms"], train_res["kpn-hq"]["ms"],
                          train_res["flagship-hq"]["ms"], train_res["loader_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                             "count": card["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
