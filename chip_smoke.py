"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Drives the port's main paths through the entry points a user calls —
`deepdenoiser-torch denoise` (cli.main) and the frame factories of
inference/pipeline.py at 1080p with the release weights; `synth-data`,
`prepare-data`, `train` and `denoise --checkpoint` for kpn-hq at the
training recipe's batch and crop; the path tracer's 1080p frame and the
train step fed by batches made on the card; the TF goldens, a TF checkpoint
of kpn-hq, the pretraining recipe and the release export; the measurement
and evaluation tools of deepdenoiser_tpu_torch/tools/, the headline
benchmark, the roofline and the EXR codec's native path — and checks every
CUDA kernel against
its plain PyTorch version on the card. Phases, each
printing its results on its own lines; any failure raises and the run exits
non-zero:

  1. card        name, count, power limit; fails without a CUDA device
  2. build       nvcc every csrc/*.cu and c++ csrc/exr_pack.cpp (ops/_build.py),
                 all at once; the ptxas report
  3. kernels     the KPN filter apply vs its plain version at the paths'
                 shapes, the train step's batch among them (max|d| <= 1e-5
                 + 1e-5*|ref|), with the weights in the head's contiguous
                 (N,H,W,k²) layout (and one planar view), ragged, one-row and
                 odd-width frames, two launches bitwise equal; at each path
                 shape its time beside useful and moved bytes, the bound,
                 tile rows and resident blocks per SM, the plain version's
                 time, and at the training batch a launch that only writes
                 the output (the floor of a launch that size); the KPN head's
                 norm-and-softmax kernel vs its plain version (1e-6 +
                 1e-4*|ref|) on every slot view at the three frame cells'
                 shapes, k=3, the norm off, ragged and cropped views, its
                 time beside useful and moved bytes and the plain chain's,
                 one launch a slot of a head and none of the chain's kernels;
                 the conv epilogue kernel (bias and activation) vs its
                 plain version, bit for bit, at every conv output of the
                 kpn-hq, flagship-max, tiled 4K and tiramisu-lt1 network
                 calls, its device ms a frame beside the bytes floor, the
                 plain version's and PyTorch's add_ + activation, one launch
                 a conv of a kpn-hq and a tiramisu-lt1 frame (each phase
                 holds its path's count, from EPILOGUES);
                 the five per-pass
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
                 backward (1e-5 + 1e-5*|ref|) on the inputs the kpn-hq train
                 step hands over: all 8 slot views (channels 3s..3s+2) of
                 (16,96,96,24) signal and gradient tensors, the joint 1080p
                 plane, k=3, C=1 and C=4, ragged and one-row frames; two
                 launches bitwise equal; the weights as the head hands them
                 (contiguous (N,H,W,k²)), and d_w returned in that layout,
                 contiguous; device times by CUDA-graph replay at
                 the training batch (slots 0 and 2, contiguous) and the plane
                 (slot 0, contiguous), useful bytes (the bound) and the bytes
                 of the 32 B sectors and 64 B blocks the views touch, resident
                 blocks per SM, the plain version's time; d_w at slot 0 of 8-
                 and 16-channel stacks beside the 24; with --parent-csrc DIR,
                 the planar-d_w kernels built from DIR held bitwise equal and
                 timed beside, in the same turns
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
                 must halve) and flagship-hq's ms/step and loss curve over 30
                 beside it, in bf16 and in fp32 (TF32 off)
  19. mc        bench.py's MC column: make_scene(0) traced at 1080p on the card
                 (data/mc_tracer.py), GT 1024 spp timed by host clock around a
                 synchronize, noisy 4 spp; combined == recompose; the card
                 against the port on the CPU at 96x128 for scenes 0 and 5 (the
                 deterministic buffers under the flip bar: at most 0.2 % of the
                 pixels differ, each within 1 px of an edge; direct and
                 indirect within Monte-Carlo error); kpn-hq (8 K1 launches a
                 frame) and flagship-mc through make_joint_frame_denoiser on the
                 traced frame: gain, bf16 within 0.05 dB of fp32 (flagship-mc:
                 0.15 dB, ROADMAP.md §3 (l)), ms per frame;
                 both models' gains on bench.py's four families at 1080p
                 (Fourier, spheres, boxes with add_mc_noise(spp=4, seed=1), mc;
                 the two holdouts made by a worker process started with the run)
  20. device-batch  training_batch (data/synthetic_device.py) at batch 16,
                 crop 96, joint, each of the five families on the card: ms a
                 batch by CUDA events, peak memory; then the kpn-hq train step
                 (phase 18's recipe) fed only by mixed-mc batches: ms a step
                 with the synthesis and the step alone, beside phase 18's; 8
                 K1 and 8 d_w launches a step; finite loss
  21. multi-device  every path on the one card: kpn-hq at 1080p in 2 and 4
                 bands (spatial_shard, mesh ["cuda:0"] * n): 8 K1 launches a
                 band, fp32 (TF32 off) banded == the whole frame with the
                 certified halo within 1e-4 x max|ref| per pass, bf16 gain
                 within 0.05 dB of fp32, ms per frame and peak beside the
                 whole frame's; flagship-max in 4 bands with the fused ingest
                 (1 group-encode and 8 K1 launches a frame, fp32 == whole);
                 4 noisy frames through make_batch_frame_denoiser on
                 ["cuda:0"] * 4 (32 K1 launches, each frame == its own
                 denoise); make_train_step on 2 gloo ranks sharing the card
                 (spawned; fp32, 3 steps == the one-rank global step: loss and
                 grad_norm rel 1e-5, parameters 2e-6; 8 K1 and 8 d_w launches
                 a rank and step; the gradient all-reduce timed), `train`
                 under torch.distributed.run --nproc_per_node 2 for 10 steps
                 of phase 18's recipe, and `denoise --checkpoint` of that run
                 in one process
  22. release   the release tooling at full width: the four frozen TF goldens
                 (tests/goldens/tf_compat) read without TensorFlow and forwarded
                 on the card in fp32 (max|d| <= 2e-5; 2 K1 launches, k=3, for
                 kpn); the four goldens made by the port on the card
                 (compat/goldens.make: seed-7 init, the port's TF writer, the
                 fp32 forward) and read back by goldens.check on the card and
                 on the CPU (max|d| <= 2e-5 each; checkpoint bytes equal to a
                 CPU make's; make and check seconds; 2 + 2 K1 launches for
                 kpn); kpn-hq's
                 release npz through the port's TF writer and
                 reader, bitwise, with the bundle's bytes and the write and read
                 seconds, and the 1080p frame with those weights bitwise equal to
                 the release weights' frame (8 K1 launches); the recipe
                 (tools/pretrain_flagship.py): kpn-hq --init-from its release
                 npz, --teacher flagship-hq, mixed family, batch 16, crop 96, 20
                 steps, validation every 10 (8 K1 and 8 d_w launches a step, 8 K1
                 a validation batch, counted apart; a -best checkpoint with its
                 extra), ms/step and peak memory, and the same run without the
                 teacher; the -best checkpoint through
                 tools/export_release_weights.py (the release file's keys, shapes
                 and fp16) and `deepdenoiser-torch denoise --weights` on the 1080p
                 frame (gain > 0, 8 K1 launches)
  23. tools     the port's measurement and evaluation tools
                 (deepdenoiser_tpu_torch/tools/), each main(argv) in-process
                 on the card, stdout captured, its last JSON line checked and
                 each frame denoiser's K1 launches a frame counted:
                 bench_model kpn-hq at 1080p, border 32 (8 a frame; its
                 latency beside phase 4's median) and kpn (group, 2);
                 bench_4k kpn-hq, 2 frames, at tile 512 / tile_batch 8 (40 a
                 frame) and at two of sweep_4k's configs, the whole frame with
                 border 32 (8) and tile 1088 / tile_batch 2 (32);
                 bench_sequence kpn-hq over 4 coherent 4K frames (8, gain > 0);
                 bench_input_pipeline kpn-hq, batch 16, crop 96, 30 steps
                 (8 K1 and 8 d_w a step, every rate > 0); eval_holdout and
                 eval_zoo (kpn-hq 8, flagship-hq 0, kpn 2, with the traced
                 column) at 540x960, every gain > 0; profile (a Chrome trace
                 holding frame_0 and frame_1); measure() of the first config
                 of sweep_bench and sweep_joint at 1080p; diag_multiscale on
                 seeded weights; split_multilayer on the 1080p frame's
                 multilayer EXR (the split passes equal the frame's)
  24. bench     tools/bench.py (the headline record: 1080p fps and the gains
                 on the four families) in-process with its defaults
                 (flagship-hq, flagship, flagship-mc) and with --model kpn-hq
                 (8 K1 a frame), on the frames the earlier phases made (the
                 Fourier frame, the worker's holdouts, phase 19's traced
                 frame): the JSON contract, every gain > 0, the headline's ms
                 within 3 % of phase 5's (flagship-hq) and phase 4's (kpn-hq)
                 medians
  25. roofline  tools/roofline.py for kpn-hq, flagship-hq and flagship at
                 1080p, border 32: FLOPs and bytes counted from the shapes
                 over the CUDA-event latency, 0 < mfu <= 1 and 0 <
                 hbm_utilization <= 1.05; tools/traffic_breakdown.py --time
                 for kpn-hq (stage GFLOP, GB and ms, the op table with K1's
                 8 launches)
  26. exr       the 1080p multilayer EXR of phase 23 read and written back in
                 turns (numpy, native, native, numpy) by the worker process:
                 passes and files bit-equal across the turns, the seconds of
                 each
  27. one JSON line {"kernels": [...]}; every phase's seconds on [time] lines
  (with --profile, the frame phases and the train steps also print device
  time by kernel, every copy kernel's row and the device's busy share, from
  torch.profiler; with --parent-csrc DIR as well, kpn-hq's step is profiled
  again with DIR's planar d_w and its 8 more copy launches a step checked)
  then the card's name and power limit as nvidia-smi prints them, and last
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Imports nothing of JAX or of the JAX package. Builds into build/ (listed
in .gitignore) and writes its scratch frame and configs there.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import io
import itertools
import json
import math
import multiprocessing
import os
import pickle
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
# conv epilogue (ops/bias_act) launches a network call: one a ConvBlock and
# one for the 1x1 head; unet-multiscale runs its base UNet at 3 scales
EPILOGUES = {"kpn-hq": 21, "flagship-hq": 21, "flagship": 21, "flagship-mc": 21,
             "flagship-max": 21, "kpn": 21,
             "tiramisu-lt1": 33, "tiramisu-fast": 39, "tiramisu": 36, "unet-multiscale": 63,
             "rgb-small": 10, "base-16 depth-2": 15, "sweep s2d depth-3": 14,
             # compat/goldens.GOLDEN_CFGS, one forward a make or a check
             "golden unet": 15, "golden tiramisu": 16, "golden multiscale": 20, "golden kpn": 10}


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


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN's deterministic algorithms only inside the block: two runs of
    the same step then agree bit for bit (by default the weight gradient of
    a conv may come from an algorithm whose summation order varies)."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def reset_launches() -> None:
    from deepdenoiser_tpu_torch.ops import bias_act, fused_ingest, kpn_apply, kpn_softmax

    kpn_apply.reset_launches()
    kpn_softmax.reset_launches()
    bias_act.reset_launches()
    fused_ingest.reset_launches()


def read_launches() -> dict:
    from deepdenoiser_tpu_torch.ops import bias_act, fused_ingest, kpn_apply, kpn_softmax

    return {"kpn_apply": kpn_apply.launches, "kpn_apply_bwd_weights": kpn_apply.bwd_weights_launches,
            "kpn_apply_bwd_noisy": kpn_apply.bwd_noisy_launches,
            "kpn_softmax": kpn_softmax.launches, "bias_act": bias_act.launches,
            **fused_ingest.launches}


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
    paths = _build.build([*_build.sources(), "exr_pack"])  # the EXR codec's host library too
    log(f"[build] {len(paths)} source(s) in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(p.name for p in paths.values()))
    for name in _build.sources():
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


def _kpn_inputs(shape, k, stack_channels, gen, planar=False):
    """noisy (N,H,W,C) and softmaxed weights (N,H,W,k²) on the card, the
    weights contiguous with the taps last, as the KPN head hands them to the
    kernel. With stack_channels, the noisy slot is a 3-channel slice of the
    fp32 signal stack (24 channels in joint mode, the 14-channel network
    input in group mode). `planar`: the weights are instead a permuted view
    of planar (N,k²,H,W) softmax output (correctness only)."""
    n, h, w, c = shape
    dev = "cuda"
    if stack_channels:
        noisy = torch.rand((n, h, w, stack_channels), generator=gen, device=dev)[..., 3:6]
    else:
        noisy = torch.rand(shape, generator=gen, device=dev)
    if planar:
        logits = torch.randn((n, k * k, h, w), generator=gen, device=dev)
        return noisy, torch.softmax(logits, dim=1).permute(0, 2, 3, 1)
    logits = torch.randn((n, h, w, k * k), generator=gen, device=dev)
    return noisy, torch.softmax(logits, dim=-1)


def _moved_bytes(t: torch.Tensor, granule: int) -> int:
    """Bytes of the `granule`-byte blocks of device memory that a view's
    elements lie in; a contiguous tensor's own bytes, rounded up."""
    if t.is_contiguous():
        return -(-t.numel() * t.element_size() // granule) * granule
    return _touched_bytes(t, granule)


def phase_kernels(card: dict) -> dict:
    """The KPN filter apply against its plain version, at the head's layout
    (and one planar view). Returns the timing at the joint path's shape,
    with the group path's under "group", the tiled frame's tile batch under
    "tile" and the kpn-hq train step's batch under "train"."""
    from deepdenoiser_tpu_torch.models import kpn
    from deepdenoiser_tpu_torch.ops import kpn_apply
    from deepdenoiser_tpu_torch.tools import roofline

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # (shape, k, channels of the stack the slot is cut from, path it is timed
    # for, planar weights); W*k*k not a multiple of 4 (53, 45, 21, 9 wide)
    # takes the kernel's shifted weight rows
    cases = [((1, PLANE_H, PLANE_W, 3), 5, 24, "joint", False),
             ((4, PLANE_H, PLANE_W, 3), 5, 14, "group", False),
             ((TILE_BATCH, NET_TILE, NET_TILE, 3), 5, 24, "tile", False),  # a tiled joint chunk
             ((TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 3), 5, 24, "train", False),  # the train step's
             ((4, 260, 390, 3), 3, 0, None, False), ((1, 37, 53, 3), 5, 0, None, False),
             ((2, 1, 45, 3), 5, 24, None, False), ((3, 19, 21, 1), 3, 0, None, False),
             ((2, 23, 9, 4), 5, 0, None, False),
             ((1, 64, 64, 3), 3, 8, None, False),  # the kpn TF golden's slot 1 (phase 22)
             ((2, 40, 72, 3), 5, 24, None, True)]  # planar weights: still taken
    worst = 0.0
    timings = {}
    resident = {rows: kpn_apply.resident_blocks("forward", 5, 3, rows) for rows in (8, 4)}
    regs = {rows: _ptxas_registers("kpn_apply", f"kpn_apply_kernelILi5ELi3ELi{rows}E")
            for rows in (8, 4)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log("[kernels] kpn_apply resident blocks per SM at k=5, C=3 (occupancy API): " + ", ".join(
        f"32x{rows} tiles {resident[rows]} ({regs[rows]} registers)" for rows in (8, 4))
        + f"; {sms} SMs")
    for shape, k, stack_channels, path, planar in cases:
        noisy, weights = _kpn_inputs(shape, k, stack_channels, gen, planar)
        got = kpn_apply.apply_cuda(noisy, weights, k)
        again = kpn_apply.apply_cuda(noisy, weights, k)
        ref = kpn.apply_per_pixel_kernels(noisy, weights, k)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        bad = int((err > TOL_ABS + TOL_REL * ref.abs()).sum())
        max_err = float(err.max())
        worst = max(worst, max_err)
        log(f"[kernels] kpn_apply {shape} k={k} slot of a {stack_channels or 3}-channel stack, "
            f"{'planar' if planar else 'NHWC'} weights: max|d|={max_err:.3e} over tolerance={bad}")
        if bad or not torch.isfinite(got).all():
            raise AssertionError(f"kpn_apply disagrees with its plain version at {shape} k={k}")
        if not torch.equal(got, again):
            raise AssertionError(f"kpn_apply: two launches differ at {shape} k={k}")
        del got, again, ref, err
        if path:  # a path's shape
            n, h, w, c = shape
            if path == "train":
                # a 10 us launch: CUDA-graph replay over buffer sets larger
                # than the L2, as phase 16 times the backward
                bufs = [(noisy, weights)] + [_kpn_inputs(shape, k, stack_channels, gen)
                                             for _ in range(10)]
                kernel_ms = graph_ms([lambda b=b: kpn_apply.apply_cuda(*b, k) for b in bufs])
                plain_ms = graph_ms([lambda b=b: kpn.apply_per_pixel_kernels(*b, k) for b in bufs],
                                    replays=3)
                # the floor of a launch this size: one that only writes the
                # (N,H,W,C) output, timed the same way
                outs = [torch.empty(shape, device="cuda") for _ in bufs]
                write_ms = graph_ms([lambda o=o: o.zero_() for o in outs])
                del bufs, outs
            else:
                kernel_ms = cuda_ms(lambda: kpn_apply.apply_cuda(noisy, weights, k), iters=200 // n)
                plain_ms = cuda_ms(lambda: kpn.apply_per_pixel_kernels(noisy, weights, k),
                                   iters=20 // n)
                write_ms = None
            px = n * h * w
            rows = kpn_apply.tile_rows(shape, k)
            blocks = n * -(-h // rows) * -(-w // 32)
            # each input read once, the output written once (the roofline's counter)
            work = roofline.count_kpn_apply(n, h, w, k, c)
            nbytes, flops = work.bytes, work.flops
            moved = {g: _moved_bytes(noisy, g) + _moved_bytes(weights, g) + px * c * 4
                     for g in (32, 64)}
            bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
            ops_ms = flops / H100_FP32_FLOP_PER_S * 1e3
            timing = timings[path] = {
                "shape": list(shape), "k": k, "ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "flops": flops, "moved32": moved[32], "moved64": moved[64],
                "moved32_bound_ms": moved[32] / H100_BYTES_PER_S * 1e3,
                "moved64_bound_ms": moved[64] / H100_BYTES_PER_S * 1e3,
                "tile_rows": rows, "blocks": blocks, "resident_blocks_per_sm": resident[rows],
                "write_only_ms": write_ms,
            }
            log(f"[kernels] kpn_apply {shape} k={k} ({path} path): {kernel_ms * 1e3:.1f} us/launch, "
                f"{100 * timing['bound_ms'] / kernel_ms:.0f}% of the bound "
                f"{timing['bound_ms'] * 1e3:.1f} us by {timing['bound_by']} ({nbytes / 1e6:.1f} MB "
                f"useful at 3.35 TB/s, {flops / 1e9:.3f} GFLOP at 67 TFLOP/s = "
                f"{ops_ms * 1e3:.1f} us; {nbytes / (kernel_ms * 1e-3) / 1e12:.2f} TB/s useful); "
                f"moved {moved[32] / 1e6:.1f} MB in 32 B sectors = "
                f"{timing['moved32_bound_ms'] * 1e3:.1f} us, {moved[64] / 1e6:.1f} MB in 64 B "
                f"blocks = {timing['moved64_bound_ms'] * 1e3:.1f} us; 32x{rows} tiles, {blocks} "
                f"blocks, {resident[rows]} resident/SM ({blocks / (resident[rows] * sms):.2f} "
                f"waves); plain version {plain_ms * 1e3:.1f} us"
                + (f"; a launch writing only the output {write_ms * 1e3:.1f} us" if write_ms else "")
                + f" | {card['smi']}")
        del noisy, weights
    torch.cuda.empty_cache()
    return {**timings["joint"], "group": timings["group"], "tile": timings["tile"],
            "train": timings["train"], "max_abs_err": worst}


# The KPN head's norm-and-softmax kernel at the frame cells' network calls:
# (path, (N, H, W), channels of the backbone output the slots are cut from)
SOFTMAX_PATHS = [("kpn-hq 1080p", (1, PLANE_H, PLANE_W), 200),
                 ("flagship-max 1080p", (4, PLANE_H, PLANE_W), 50),
                 ("kpn-hq 4K tile batch", (TILE_BATCH, NET_TILE, NET_TILE), 200)]
# |d| <= abs + rel*|ref|: the same fp32 operations, the sums in another
# order; exp carries z's rounding (|z| up to tau*k = 80) into the weight
SOFTMAX_TOL_ABS, SOFTMAX_TOL_REL = 1e-6, 1e-4


def _softmax_case(lead, channels, k, norm, gen, crop=False):
    """Backbone logits (lead, channels) on the card, 3x a unit normal, and
    the slots' temperatures in (0, 16), or None without the norm; `crop`
    cuts the frame's border off, so N, H and W strides no longer merge."""
    feats = 3 * torch.randn((*lead, channels), generator=gen, device="cuda")
    if crop:
        feats = feats[:, 1:-2, 3:-1, :]
    slots = channels // (k * k)
    taus = None
    if norm:
        taus = 16 * torch.sigmoid(2 * torch.randn((slots,), generator=gen, device="cuda"))
    return feats, taus, slots


def _softmax_err(what: str, got, ref) -> float:
    err = (got - ref).abs()
    bad = int((err > SOFTMAX_TOL_ABS + SOFTMAX_TOL_REL * ref.abs()).sum())
    if bad or got.shape != ref.shape or not got.is_contiguous() or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: {bad} weights over tolerance, max|d|={float(err.max()):.3e}")
    return float(err.max())


def phase_kpn_softmax(card: dict) -> dict:
    """The KPN head's RMS norm, temperature and softmax kernel
    (ops/kpn_softmax.py) against its plain version: every slot at the three
    frame cells' shapes, k=3 (the kpn golden's 2 slots), the norm off,
    ragged and cropped views; two launches bitwise equal; at each path
    shape its time by CUDA events over the slots in turn beside useful and
    moved bytes, and the plain chain's time; the launches of a kpn-hq and a
    flagship-max head on the card, and none of the plain chain's kernels."""
    from deepdenoiser_tpu_torch.models import kpn
    from deepdenoiser_tpu_torch.ops import kpn_softmax

    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    kpn_softmax.reset_launches()
    launched = 0
    worst = 0.0
    timings = {}
    checks = [(path, lead, ch, 5, True, False) for path, lead, ch in SOFTMAX_PATHS] + [
        (None, (1, 64, 64), 18, 3, True, False), (None, (3, 37, 53), 18, 3, False, False),
        (None, (2, 23, 41), 200, 5, False, False), (None, (2, 40, 72), 200, 5, True, True),
        (None, (1, 1, 5), 25, 5, True, False)]
    for path, lead, channels, k, norm, crop in checks:
        feats, taus, slots = _softmax_case(lead, channels, k, norm, gen, crop)
        k2 = k * k
        views = [feats[..., s * k2 : (s + 1) * k2] for s in range(slots)]
        err = 0.0
        tau = [None if taus is None else taus[s] for s in range(slots)]
        for s, logits in enumerate(views):
            got = kpn_softmax.softmax_cuda(logits, tau[s])
            again = kpn_softmax.softmax_cuda(logits, tau[s])
            launched += 2
            ref = kpn_softmax.softmax_plain(logits, tau[s])
            torch.cuda.synchronize()
            err = max(err, _softmax_err(f"kpn_softmax {tuple(logits.shape)} slot {s}", got, ref))
            if not torch.equal(got, again):
                raise AssertionError(f"kpn_softmax: two launches differ at {tuple(logits.shape)}")
            del got, again, ref
        worst = max(worst, err)
        log(f"[kpn-softmax] {tuple(views[0].shape)} k={k} of a {channels}-channel output "
            f"({slots} slots{', cropped' if crop else ''}), norm {'on' if norm else 'off'}: "
            f"max|d|={err:.3e}")
        if path:
            n, h, w = views[0].shape[:3]
            px = n * h * w
            calls = [lambda s=s, lg=lg: kpn_softmax.softmax_cuda(lg, tau[s])
                     for s, lg in enumerate(views)]
            before = kpn_softmax.launches
            kernel_ms = cuda_ms(rotating(calls), iters=10 * len(calls))
            launched += kpn_softmax.launches - before
            plain_ms = cuda_ms(rotating([lambda s=s, lg=lg: kpn_softmax.softmax_plain(lg, tau[s])
                                         for s, lg in enumerate(views)]), iters=2 * len(calls))
            useful = 2 * px * k2 * 4  # the slot's logits read once, the weights written once
            moved = {g: _moved_bytes(views[-1], g) + px * k2 * 4 for g in (32, 64)}
            timing = timings[path] = {
                "shape": list(views[0].shape), "k": k, "slots": slots, "ms": kernel_ms,
                "plain_ms": plain_ms, "bytes": useful, "flops": 0, "bound_by": "bytes",
                "bound_ms": useful / H100_BYTES_PER_S * 1e3,
                "moved32": moved[32], "moved64": moved[64],
                "moved32_bound_ms": moved[32] / H100_BYTES_PER_S * 1e3,
                "moved64_bound_ms": moved[64] / H100_BYTES_PER_S * 1e3, "max_abs_err": err,
            }
            log(f"[kpn-softmax] {path} {tuple(views[0].shape)}: {kernel_ms * 1e3:.1f} us/launch; "
                f"bound {timing['bound_ms'] * 1e3:.1f} us by useful bytes ({useful / 1e6:.1f} MB, "
                f"{100 * timing['bound_ms'] / kernel_ms:.1f}%), "
                f"{timing['moved32_bound_ms'] * 1e3:.1f} us by moved bytes in 32 B sectors "
                f"({moved[32] / 1e6:.1f} MB, {100 * timing['moved32_bound_ms'] / kernel_ms:.1f}%), "
                f"{timing['moved64_bound_ms'] * 1e3:.1f} us in 64 B blocks ({moved[64] / 1e6:.1f} "
                f"MB, {100 * timing['moved64_bound_ms'] / kernel_ms:.1f}%); "
                f"{useful / (kernel_ms * 1e-3) / 1e12:.2f} TB/s useful; plain chain "
                f"{plain_ms * 1e3:.1f} us ({plain_ms / kernel_ms:.1f}x) | {card['smi']}")
        del feats, views, tau
        torch.cuda.empty_cache()
    if kpn_softmax.launches != launched:
        raise AssertionError(f"kpn_softmax: {kpn_softmax.launches} launches counted, "
                             f"{launched} made")

    # the heads on the card: one launch a slot, none of the plain chain's kernels
    heads = {}
    for name, slots in (("kpn-hq", 8), ("flagship-max", 2)):
        head = kpn.KernelPredictionHead(5, slots, logit_norm=True).to("cuda")
        feats = 3 * torch.randn((2, 24, 40, slots * 25), generator=gen, device="cuda")
        signal = torch.rand((2, 24, 40, 3 * slots), generator=gen, device="cuda")
        kpn_softmax.reset_launches()
        with torch.no_grad(), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            head(feats, signal)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        chain = [n for n in names if "softmax_warp" in n or "reduce_kernel" in n]
        if kpn_softmax.launches != slots or chain or not any("kpn_softmax_kernel" in n
                                                               for n in names):
            raise AssertionError(f"{name} head: {kpn_softmax.launches} kpn_softmax launches "
                                 f"(want {slots}), plain-chain kernels {chain}")
        heads[name] = kpn_softmax.launches
        log(f"[kpn-softmax] {name} head on the card: {kpn_softmax.launches} launches, device "
            f"kernels {sorted(set(n[:40] for n in names))}")
    return {**timings["kpn-hq 1080p"], "max_abs_err": worst, "by_path": timings,
            "launches": launched, "head_launches": heads}


# the conv epilogue's paths, the frame cells': (name, preset, network batch
# (N, H, W), network calls a frame)
BIAS_ACT_PATHS = [("kpn-hq 1080p", "kpn-hq", (1, PLANE_H, PLANE_W), 1),
                  ("flagship-max 1080p", "flagship-max", (4, PLANE_H, PLANE_W), 1),
                  ("kpn-hq tiled 4K", "kpn-hq", (TILE_BATCH, NET_TILE, NET_TILE),
                   -(-(-(-UHD_H // TILE) * -(-UHD_W // TILE)) // TILE_BATCH)),
                  ("tiramisu-lt1 1080p", "tiramisu-lt1", (1, PLANE_H, PLANE_W), 1)]
# frames whose launches are held against the profiler's trace: preset -> weights
BIAS_ACT_FRAMES = {"kpn-hq": "kpn_hq_ema_f16.npz", "tiramisu-lt1": "tiramisu_lt1_ema_f16.npz"}


def _epilogue_calls(preset: str, lead) -> list:
    """(shape, act) of every conv output of the preset's network over an
    (N, H, W) batch, in order: one forward on the card at random weights,
    the op wrapped."""
    from deepdenoiser_tpu_torch import config
    from deepdenoiser_tpu_torch.models import factory
    from deepdenoiser_tpu_torch.ops import bias_act

    mcfg = config.validate_channels(config.PRESETS[preset]).model
    model = factory.init_model(mcfg, torch.Generator().manual_seed(0)).to("cuda")
    calls, op = [], bias_act.bias_act

    def seen(z, b, act):
        calls.append((tuple(z.shape), act))
        return op(z, b, act)

    bias_act.bias_act = seen
    try:
        with torch.inference_mode():
            model(torch.rand((*lead, mcfg.in_channels), device="cuda"))
        torch.cuda.synchronize()
    finally:
        bias_act.bias_act = op
    del model
    torch.cuda.empty_cache()
    return calls


def phase_bias_act(card: dict) -> dict:
    """The conv epilogue kernel (ops/bias_act.py) at the four frame cells'
    paths: each conv output of a network call, bf16 channels-last, against
    the plain version (equal bit for bit; every activation and layout is
    held in tests/test_torch_gpu.py); device ms of a network call's launches
    by CUDA-graph replay, times the calls a frame, beside the bytes floor
    (each output read with its bias and written once), the plain version's,
    and PyTorch's chain that ran before the kernel, `add_` of the cast bias
    and the activation (timed here, never called by the port); the launches
    of a small kpn-hq and tiramisu-lt1 frame against the kernels in the
    profiler's trace (the frame phases hold each path's count)."""
    from deepdenoiser_tpu_torch import config, weights_io
    from deepdenoiser_tpu_torch.data import synthetic
    from deepdenoiser_tpu_torch.inference import pipeline
    from deepdenoiser_tpu_torch.ops import bias_act

    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    timings = {}
    for path, preset, lead, calls_per_frame in BIAS_ACT_PATHS:
        calls = _epilogue_calls(preset, lead)
        zs, bs = [], []
        for shape, act in calls:
            z = (3 * torch.randn(shape, generator=gen, device="cuda")).to(torch.bfloat16)
            zs.append(z.contiguous(memory_format=torch.channels_last))
            bs.append(torch.randn((shape[1],), generator=gen, device="cuda"))
        for z, b, (shape, act) in zip(zs, bs, calls):
            got = bias_act.bias_act_cuda(z.clone(), b, act, z.clone())
            ref = bias_act.bias_act_plain(z, b, act)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"bias_act {shape} {act}: not the plain chain's bits")
            del got, ref
        acts = [act for _, act in calls]
        kernel = [lambda z=z, b=b, a=a: bias_act.bias_act_cuda(z, b, a, z)
                  for z, b, a in zip(zs, bs, acts)]
        plain = [lambda z=z, b=b, a=a: bias_act.bias_act_plain(z, b, a)
                 for z, b, a in zip(zs, bs, acts)]
        library = [lambda z=z, b=b, a=a: bias_act.ACTIVATIONS[a](
            z.add_(b.to(z.dtype).view(1, -1, 1, 1))) for z, b, a in zip(zs, bs, acts)]
        per_call = {name: graph_ms(fns, replays=5) * len(fns)
                    for name, fns in (("kernel", kernel), ("plain", plain), ("library", library))}
        nbytes = sum(z.numel() * 2 * z.element_size() + b.numel() * 4 for z, b in zip(zs, bs))
        big = max(range(len(zs)), key=lambda i: zs[i].numel())
        big_ms = graph_ms([kernel[big]], replays=5)
        big_bytes = 2 * zs[big].numel() * zs[big].element_size()
        t = timings[path] = {
            "shape": list(zs[big].shape), "launches_per_call": len(calls),
            "calls_per_frame": calls_per_frame,
            "ms": per_call["kernel"] * calls_per_frame,
            "plain_ms": per_call["plain"] * calls_per_frame,
            "library_ms": per_call["library"] * calls_per_frame, "bytes": nbytes * calls_per_frame,
            "flops": 0, "bound_by": "bytes",
            "bound_ms": nbytes * calls_per_frame / H100_BYTES_PER_S * 1e3, "max_abs_err": 0.0,
            "largest_ms": big_ms, "largest_bound_ms": big_bytes / H100_BYTES_PER_S * 1e3,
        }
        log(f"[bias-act] {path}: {len(calls)} launches a network call x {calls_per_frame}: "
            f"{t['ms']:.3f} ms a frame, bound {t['bound_ms']:.3f} ms by {t['bytes'] / 1e9:.3f} GB "
            f"({100 * t['bound_ms'] / t['ms']:.1f}%, {t['bytes'] / t['ms'] / 1e9:.2f} TB/s); "
            f"plain version {t['plain_ms']:.3f} ms; PyTorch add_ + activation {t['library_ms']:.3f} "
            f"ms ({t['library_ms'] / t['ms']:.2f}x); largest {tuple(zs[big].shape)} "
            f"{big_ms * 1e3:.1f} us ({100 * t['largest_bound_ms'] / big_ms:.1f}% of its bound) "
            f"| {card['smi']}")
        del zs, bs, kernel, plain, library
        torch.cuda.empty_cache()

    h, w = 64, 96
    noisy = synthetic.add_mc_noise(synthetic.generate_clean_passes(h, w, seed=5), spp=4, seed=6)
    frame = {k: torch.from_numpy(v) for k, v in noisy.items()}
    for preset, weights in BIAS_ACT_FRAMES.items():
        want = EPILOGUES[preset]
        cfg = config.validate_channels(config.PRESETS[preset])
        params = weights_io.load_release_params(ROOT / "weights" / weights)
        den, _ = pipeline.make_joint_frame_denoiser(cfg.model, cfg.infer, h, w, params)
        den(frame)
        bias_act.reset_launches()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            den(frame)
            torch.cuda.synchronize()
        n_kernels = sum(e.count for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and "bias_act_kernel" in e.key)
        if bias_act.launches != want or n_kernels != want:
            raise AssertionError(f"{preset} frame: {bias_act.launches} bias_act launches counted, "
                                 f"{n_kernels} bias_act_kernel in the trace, want {want}")
        log(f"[bias-act] {preset} frame on the card: {bias_act.launches} launches, "
            f"{n_kernels} bias_act_kernel in the trace")
    return {**timings["kpn-hq 1080p"], "by_path": timings}


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
    """(bytes, operations) of one group encode, from the roofline's counter
    (tools/roofline.count_group_encode)."""
    from deepdenoiser_tpu_torch.tools import roofline

    work = roofline.count_group_encode(groups, npix, 1, aux)
    return work.bytes, work.flops


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


def profile_frames(preset: str, run, card: dict, frames: int = 3, top: int = 12) -> dict:
    """Device time by kernel over `frames` frames (torch.profiler), and the
    share of the wall time the device was busy. Returns ms a frame busy and
    wall, and the copies' launches and ms a frame."""
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
    # every copy on the device, each dtype and layout its own row (a strided
    # copy of one dtype may run as a 2-D memcpy, not as a kernel)
    copies = [e for e in kernels if "direct_copy" in e.key or "Memcpy" in e.key]
    for e in sorted(copies, key=lambda e: -e.self_device_time_total):
        log(f"[{preset}]   copy {e.self_device_time_total / frames / 1e3:8.3f} ms/frame "
            f"{e.count / frames:6.2f}x  {e.key[:110]}")
    res = {"busy_ms": busy_us / frames / 1e3, "wall_ms": wall_us / frames / 1e3,
           "copy_ms": sum(e.self_device_time_total for e in copies) / frames / 1e3,
           "copy_launches": sum(e.count for e in copies) / frames}
    log(f"[{preset}]   copies in all: {res['copy_ms']:.3f} ms/frame, {res['copy_launches']:.2f} "
        "launches/frame")
    return res


def _frame_on_card(frame: dict):
    """(clean combined, noisy combined) on the card; the passes are numpy
    arrays or tensors already there."""
    dev = torch.device("cuda")
    return (torch.as_tensor(frame["clean"]["combined"], device=dev),
            torch.as_tensor(frame["noisy"]["combined"], device=dev))


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
                 gain_tol: float = GAIN_TOL_DB, cli: bool = True, label: str = "",
                 other_frames: dict = None) -> dict:
    """A joint-mode preset: through the CLI (unless `cli` is False), then
    through the factory, timed; `other_frames` ({name: (noisy passes on the
    card, clean combined)}) are denoised once each for their gains."""
    from deepdenoiser_tpu_torch import config, weights_io
    from deepdenoiser_tpu_torch.inference import pipeline
    from deepdenoiser_tpu_torch.models import kpn

    noisy = frame["noisy"]
    dev = torch.device("cuda")
    clean_c, noisy_c = _frame_on_card(frame)
    wpath = str(ROOT / "weights" / weights)
    res = {"preset": preset}
    label = label or preset

    if cli:  # the user's entry point
        cli_out, cli_launches = _cli_denoise(preset, frame, ["--preset", preset], wpath, "joint")
        expect_launches(f"{label} cli frame", cli_launches, kpn_apply=kernel_launches_per_frame,
                        kpn_softmax=kernel_launches_per_frame, bias_act=EPILOGUES[preset])
        res["cli_launches"] = cli_launches["kpn_apply"]
        res["cli_softmax_launches"] = cli_launches["kpn_softmax"]
        res["cli_bias_act_launches"] = cli_launches["bias_act"]
        res["cli_gain_db"] = _gain_db(cli_out, noisy_c, clean_c)

    # the same path through the pipeline factory, timed
    cfg = config.validate_channels(config.PRESETS[preset])
    params = weights_io.load_release_params(wpath)
    denoise, grid = pipeline.make_joint_frame_denoiser(cfg.model, cfg.infer, FRAME_H, FRAME_W, params)
    frame_dev = {k: torch.as_tensor(v, device=dev) for k, v in noisy.items()}
    for _ in range(2):
        out = denoise(frame_dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times = time_frames(lambda: denoise(frame_dev), timed_frames)
    launches = read_launches()
    expect_launches(f"{label} over {timed_frames} frames", launches, timed_frames,
                    kpn_apply=kernel_launches_per_frame, kpn_softmax=kernel_launches_per_frame,
                    bias_act=EPILOGUES[preset])
    out = denoise(frame_dev)
    check_frame(label, out)
    res.update(
        grid=f"{grid.net_h}x{grid.net_w} (halo {grid.halo})",
        gain_db=_gain_db(out["combined"], noisy_c, clean_c),
        ms_median=statistics.median(times), ms_min=min(times), ms_max=max(times),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches_per_frame=launches["kpn_apply"] / timed_frames,
        softmax_launches_per_frame=launches["kpn_softmax"] / timed_frames,
    )
    if res["gain_db"] <= 0 or res.get("cli_gain_db", 1.0) <= 0:
        raise AssertionError(f"{label}: no PSNR gain ({res['gain_db']}, cli {res.get('cli_gain_db')})")
    del out
    res["other_gains_db"] = {}
    for name, (other_noisy, other_clean) in (other_frames or {}).items():
        other = denoise(other_noisy)
        check_frame(f"{label} on {name}", other)
        res["other_gains_db"][name] = _gain_db(other["combined"], other_noisy["combined"],
                                               other_clean)
        del other

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
            raise AssertionError(f"{label}: bf16 gain {res['gain_db']:.4f} dB vs fp32 "
                                 f"{res['fp32_gain_db']:.4f} dB differ by {diff:.4f} > {gain_tol}")
        del ref_fn, ref_out
    if profile:
        profile_frames(preset, lambda: denoise(frame_dev), card)
    del denoise
    torch.cuda.empty_cache()
    log(f"[{label}] 1080p joint frame, grid {res['grid']}: "
        f"{res['ms_median']:.2f} ms/frame median of {timed_frames} "
        f"(min {res['ms_min']:.2f}, max {res['ms_max']:.2f}; host clock around synchronize), "
        f"peak {res['peak_gib']:.2f} GiB | {card['smi']}")
    log(f"[{label}] PSNR gain {res['gain_db']:.4f} dB"
        + (f" (cli {res['cli_gain_db']:.4f} dB)" if cli else "")
        + (f", fp32 reference {res['fp32_gain_db']:.4f} dB, limit {gain_tol} dB apart"
           if check_fp32 else "")
        + "; kpn_apply launches: "
        + (f"cli frame {res['cli_launches']}, " if cli else "")
        + f"{res['launches_per_frame']:g} per timed frame")
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
    per_frame = dict(kpn_apply=2, kpn_softmax=2, group_encode=1, bias_act=EPILOGUES[what])
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
                    2 * timed_frames, kpn_apply=2, kpn_softmax=2, bias_act=EPILOGUES[what])
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
            # the plain filter apply: no K1, the head's softmax kernel as ever
            expect_launches(f"{what} fp32 {key} encode", read_launches(), kpn_softmax=2,
                            bias_act=EPILOGUES[what],
                            **({"group_encode": 1} if key == "fused" else {}))
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
        per_frame = dict(kpn_apply=2, kpn_softmax=2, group_encode=1,
                         bias_act=EPILOGUES["base-16 depth-2"])
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
                            **(per_frame if fused else dict(kpn_apply=2, kpn_softmax=2,
                                                            bias_act=per_frame["bias_act"])))
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
    expect_launches("rgb-small cli frame", cli_launches, bias_act=EPILOGUES["rgb-small"])
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
    expect_launches(f"{what} tiled frame", launches, kpn_apply=per_frame, kpn_softmax=per_frame,
                    bias_act=EPILOGUES["kpn-hq"] * chunks)
    res["launches"] = launches["kpn_apply"]
    res["softmax_launches"] = launches["kpn_softmax"]
    res["bias_act_launches"] = launches["bias_act"]
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
    expect_launches(f"{what} whole frames", read_launches(), timed_frames + 2, kpn_apply=8,
                    kpn_softmax=8, bias_act=EPILOGUES["kpn-hq"])
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
                            kpn_apply=8 * -(-g.n_tiles // 4), kpn_softmax=8 * -(-g.n_tiles // 4),
                            bias_act=EPILOGUES["kpn-hq"] * -(-g.n_tiles // 4))
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
            expect_launches(f"{what} fp32 {key}", launches, group_encode=1, kpn_apply=2 * chunks,
                            kpn_softmax=2 * chunks, bias_act=EPILOGUES["flagship-max"] * chunks)
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
    expect_launches("unet-multiscale", read_launches(), timed_frames + 2,
                    bias_act=EPILOGUES["unet-multiscale"])
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
    # a warm-up frame, then the frames twice: unsynchronised, then each closed by a synchronize
    expect_launches("sequence", read_launches(), 2 * n_frames + 1,
                    bias_act=EPILOGUES["flagship-hq"])
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


# the kpn-hq train step's signal and head-output gradient: (N,H,W,24), slot s
# at channels 3s..3s+2 (models/factory.py, models/kpn.py)
BWD_STACK = 24
# timed slot views: slot 0 reads one 32 B sector of each 96 B pixel, slot 2
# two; "contiguous" is an (N,H,W,3) tensor of its own
BWD_TIMED = {"train": ((TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 3), (0, 2, None)),
             "plane": ((1, PLANE_H, PLANE_W, 3), (0, None))}


_planar: dict = {}


def planar_backward(csrc: Path) -> dict:
    """K1's backward entry points of another tree whose d_w kernel writes
    the planar (N,k²,H,W) layout that came before the head's NHWC one,
    built from its csrc/ directory (`--parent-csrc`) into build/: entry ->
    a function taking bwd_weights_cuda's / bwd_noisy_cuda's arguments and
    returning what that tree's wrapper returned (d_w the (N,H,W,k²) view of
    the planar result), for timing beside this tree's. Counts no launch."""
    import ctypes

    from deepdenoiser_tpu_torch.ops import _build, kpn_apply

    if not _planar:
        out = WORK / "planar_bwd.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(out),
                               str(csrc / "kpn_apply_bwd.cu")], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {csrc}/kpn_apply_bwd.cu:\n"
                               f"{proc.stdout}{proc.stderr}")
        lib = ctypes.CDLL(str(out))

        def launcher(name, d_w):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 8
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int

            # the same checks and launch as the package's wrappers, so that
            # host-clock step times compare the layouts alone
            def run(a, b, k):  # (noisy, g) for d_w, (g, weights) for d_noisy
                names = ("noisy", "g") if d_w else ("g", "weights")
                n, h, w, c = kpn_apply._check(name, dict(zip(names, (a, b))), k)
                res = torch.empty((n, k * k, h, w) if d_w else (n, h, w, c), device=a.device)
                strides = (*a.stride(), *(b.stride() if d_w else kpn_apply._w_strides(b)))
                kpn_apply._launch(name, fn, (a.data_ptr(), b.data_ptr(), res.data_ptr()),
                                  (n, h, w, c, k), strides, a.device)
                return res.permute(0, 2, 3, 1) if d_w else res
            return run

        _planar.update(bwd_weights=launcher("kpn_apply_bwd_weights_f32", True),
                       bwd_noisy=launcher("kpn_apply_bwd_noisy_f32", False))
    return _planar


def _touched_bytes(t: torch.Tensor, granule: int) -> int:
    """Bytes of the `granule`-byte aligned blocks of device memory that the
    elements of the view `t` lie in (its storage starts 512 B aligned)."""
    off = torch.full((), t.storage_offset(), dtype=torch.int64, device=t.device)
    for size, stride in zip(t.shape, t.stride()):
        off = off.unsqueeze(-1) + torch.arange(size, device=t.device) * stride
    return granule * int(torch.unique(off.flatten() * t.element_size() // granule).numel())


def _bwd_work(entry: str, noisy, weights, g, k) -> dict:
    """Bytes and operations of one backward launch. `bytes`: C + C + k*k
    floats per pixel, each read or written once (noisy + g in, d_w out; or
    g + w in, d_noisy out), the bound's count; `moved32` / `moved64`: the
    bytes of the 32 B sectors / 64 B blocks that the inputs' views touch,
    plus the contiguous output; C*k*k multiply-adds per pixel."""
    n, h, w, c = noisy.shape
    px = n * h * w
    ins, out = ((noisy, g), px * k * k * 4) if entry == "bwd_weights" else ((g, weights), px * c * 4)
    return {"bytes": px * (2 * c + k * k) * 4, "flops": px * c * k * k * 2,
            **{f"moved{b}": sum(_moved_bytes(t, b) for t in ins) + out for b in (32, 64)}}


def _bwd_inputs(shape, k, gen, slot=None, stack=BWD_STACK):
    """noisy, weights, g on the card as the kpn-hq train step hands them to
    the backward. With `slot` s: the noisy slot is channels Cs..Cs+C-1 of
    the joint model's (N,H,W,stack) fp32 signal (the torch.cat of the four
    signal runs; in group mode the signal is x[..., :6] of the 14-channel
    input) and g the same channels of the head output's (N,H,W,stack)
    gradient (torch.cat's backward hands out that slice). Without: (N,H,W,C)
    tensors of their own. The weights: contiguous (N,H,W,k²) softmax
    output, as the head passes them."""
    n, h, w, c = shape
    dev = "cuda"
    if slot is None:
        noisy = torch.rand(shape, generator=gen, device=dev)
        g = torch.randn(shape, generator=gen, device=dev)
    else:
        noisy = torch.rand((n, h, w, stack), generator=gen, device=dev)[..., c * slot : c * (slot + 1)]
        g = torch.randn((n, h, w, stack), generator=gen, device=dev)[..., c * slot : c * (slot + 1)]
    logits = torch.randn((n, h, w, k * k), generator=gen, device=dev)
    return noisy, torch.softmax(logits, dim=-1), g


def _ptxas_registers(source: str, fragment: str):
    """Registers ptxas gave the kernel of csrc/<source>.cu whose mangled
    name holds `fragment` (None if the report does not name it)."""
    from deepdenoiser_tpu_torch.ops import _build

    current = None
    for line in _build.ptxas_report(source).splitlines():
        if "Compiling entry function" in line:
            current = line
        elif current and fragment in current and (m := re.search(r"Used (\d+) registers", line)):
            return int(m.group(1))
    return None


def _bwd_label(slot, stack=BWD_STACK) -> str:
    return "contiguous" if slot is None else f"slot {slot} of {stack}"


def phase_train_kernels(card: dict, parent_csrc=None) -> dict:
    """K1's two backward entry points against the plain backward: every
    slot view of the training batch's 24-channel tensors, the joint 1080p
    plane, k=3, C=1 and C=4, ragged and narrow frames; each launched twice
    and the two results bitwise equal, both in the head's layout (d_w a
    contiguous (N,H,W,k²) tensor, d_noisy (N,H,W,C)). Device time by
    CUDA-graph replay over buffer sets larger than the L2, in turns, at the
    training batch (slots 0 and 2, contiguous) and the plane (slot 0,
    contiguous), with useful and moved bytes, and d_w at slot 0 of 8- and
    16-channel stacks (32 and 64 B pixels) to show what the stride costs.
    With `parent_csrc` (planar_backward) that tree's kernels are held
    bitwise equal to these and timed beside them, in the same turns.
    Returns entry -> timing at the training batch's slot 0, the others
    under "cases"."""
    from deepdenoiser_tpu_torch.models import kpn
    from deepdenoiser_tpu_torch.ops import kpn_apply

    parent = planar_backward(parent_csrc) if parent_csrc else {}

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    train = (TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 3)
    checks = ([(train, 5, s) for s in range(8)] + [(train, 5, None), ((1, PLANE_H, PLANE_W, 3), 5, 0),
              ((2, 130, 170, 1), 3, None), ((1, 37, 53, 4), 5, None), ((3, 61, 45, 4), 3, None),
              ((2, 20, 37, 3), 5, 5), ((TRAIN_BATCH, 1, 21, 3), 3, 2), ((1, 9, 6, 2), 5, None)])
    worst = {e: 0.0 for e in BWD_ENTRIES}
    for shape, k, slot in checks:
        noisy, weights, g = _bwd_inputs(shape, k, gen, slot)
        got = {"bwd_weights": [kpn_apply.bwd_weights_cuda(noisy, g, k) for _ in range(2)],
               "bwd_noisy": [kpn_apply.bwd_noisy_cuda(g, weights, k) for _ in range(2)]}
        ref_n, ref_w = kpn.apply_per_pixel_kernels_bwd(noisy, weights, g, k, True)
        torch.cuda.synchronize()
        errs = []
        for entry, ref in (("bwd_weights", ref_w), ("bwd_noisy", ref_n)):
            first, second = got[entry]
            err = (first - ref).abs()
            bad = int((err > TOL_ABS + TOL_REL * ref.abs()).sum())
            worst[entry] = max(worst[entry], float(err.max()))
            errs.append(f"{entry} max|d|={float(err.max()):.3e} over tolerance={bad}")
            if bad or not torch.isfinite(first).all():
                raise AssertionError(f"kpn_apply.{entry} disagrees with the plain backward at "
                                     f"{shape} k={k} ({_bwd_label(slot)})")
            if not torch.equal(first, second):
                raise AssertionError(f"kpn_apply.{entry}: two launches differ at {shape} k={k}")
            if not first.is_contiguous() or first.shape != ref.shape:
                raise AssertionError(f"kpn_apply.{entry} at {shape} k={k}: {tuple(first.shape)} "
                                     f"strides {first.stride()}, not a contiguous "
                                     f"{tuple(ref.shape)}")
            if parent and not torch.equal(first, parent[entry](
                    *((noisy, g) if entry == "bwd_weights" else (g, weights)), k)):
                raise AssertionError(f"kpn_apply.{entry} at {shape} k={k}: not bitwise the "
                                     f"planar kernel's of {parent_csrc}")
        log(f"[train-kernels] {shape} k={k} {_bwd_label(slot)}: " + "; ".join(errs)
            + "; second launch bitwise equal; d_w contiguous (N,H,W,k²)"
            + ("; bitwise the planar kernels'" if parent else ""))
        del noisy, weights, g, got, ref_n, ref_w
    torch.cuda.empty_cache()

    resident = {e: kpn_apply.resident_blocks(e, 5, 3) for e in BWD_ENTRIES}
    regs = {e: _ptxas_registers("kpn_apply_bwd", f"{name}ILi5ELi3E")
            for e, name in (("bwd_weights", "kpn_bwd_weights_kernel"),
                            ("bwd_noisy", "kpn_bwd_noisy_kernel"))}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[train-kernels] resident blocks per SM at k=5, C=3 (occupancy API): "
        + ", ".join(f"{e} {r} ({regs[e]} registers)" for e, r in resident.items())
        + f"; {sms} SMs")
    timings = {e: {} for e in BWD_ENTRIES}
    k = 5
    for path, (shape, slots) in BWD_TIMED.items():
        for slot in slots:
            bufs = [_bwd_inputs(shape, k, gen, slot)]
            work = {e: _bwd_work(e, *bufs[0], k) for e in BWD_ENTRIES}
            sets = max(2, min(16, math.ceil(4 * H100_L2_BYTES / work["bwd_weights"]["bytes"])))
            bufs += [_bwd_inputs(shape, k, gen, slot) for _ in range(sets - 1)]
            fns = {"bwd_weights": kpn_apply.bwd_weights_cuda, "bwd_noisy": kpn_apply.bwd_noisy_cuda}
            fns.update({f"parent {e}": fn for e, fn in parent.items()})
            calls = {e: [(lambda b=b, fn=fn: fn(b[0], b[2], k)) if e.endswith("bwd_weights")
                         else (lambda b=b, fn=fn: fn(b[2], b[1], k)) for b in bufs]
                     for e, fn in fns.items()}
            # in turns, this tree's first and last: w n [pw pn pn pw] n w
            turns = [*fns, *reversed(fns)]
            ms = {e: 0.0 for e in fns}
            for e in turns:
                ms[e] += graph_ms(calls[e]) / 2
            for entry in BWD_ENTRIES:
                wk = work[entry]
                bytes_ms = wk["bytes"] / H100_BYTES_PER_S * 1e3
                ops_ms = wk["flops"] / H100_FP32_FLOP_PER_S * 1e3
                plain_ms = graph_ms([lambda b=b: kpn.apply_per_pixel_kernels_bwd(
                    *b, k, entry == "bwd_noisy") for b in bufs], replays=3)
                t = timings[entry][(path, slot)] = {
                    "shape": list(shape), "k": k, "slot": slot, "stack": BWD_STACK,
                    "ms": ms[entry], "plain_ms": plain_ms, "parent_ms": ms.get(f"parent {entry}"),
                    "library_ms": None,  # no single PyTorch call computes it
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                    "moved32_bound_ms": wk["moved32"] / H100_BYTES_PER_S * 1e3,
                    "moved64_bound_ms": wk["moved64"] / H100_BYTES_PER_S * 1e3,
                    **wk, "buffer_sets": sets, "resident_blocks_per_sm": resident[entry],
                }
                log(f"[train-kernels] kpn_apply.{entry} {shape} k={k} ({path}, "
                    f"{_bwd_label(slot)}): {ms[entry] * 1e3:.1f} us/launch; bound "
                    f"{t['bound_ms'] * 1e3:.1f} us by {t['bound_by']} ({wk['bytes'] / 1e6:.1f} MB "
                    f"useful at 3.35 TB/s, {wk['flops'] / 1e9:.3f} GFLOP at 67 TFLOP/s = "
                    f"{ops_ms * 1e3:.1f} us, {wk['bytes'] / (ms[entry] * 1e-3) / 1e12:.2f} TB/s "
                    f"useful); moved {wk['moved32'] / 1e6:.1f} MB in 32 B sectors = "
                    f"{t['moved32_bound_ms'] * 1e3:.1f} us, {wk['moved64'] / 1e6:.1f} MB in "
                    f"64 B blocks = {t['moved64_bound_ms'] * 1e3:.1f} us ("
                    f"{wk['moved64'] / (ms[entry] * 1e-3) / 1e12:.2f} TB/s); plain backward "
                    + ("(d_w only)" if entry == "bwd_weights" else "(both gradients)")
                    + f" {plain_ms * 1e3:.1f} us"
                    + (f"; the planar kernel of {parent_csrc} {t['parent_ms'] * 1e3:.1f} us"
                       if parent else "")
                    + f"; {resident[entry]} resident blocks/SM; CUDA-graph replay over {sets} "
                    f"buffer sets, in turns | {card['smi']}")
            del bufs, calls
            torch.cuda.empty_cache()
    # what the pixel stride costs d_w: slot 0 of 8-, 16- and 24-channel stacks
    # put a slot's 12 B in one 32 B sector of a 32, 64 and 96 B pixel
    shape = BWD_TIMED["train"][0]
    probe = {}
    for stack in (8, 16):
        bufs = [_bwd_inputs(shape, k, gen, 0, stack) for _ in range(11)]
        probe[stack] = graph_ms([lambda b=b: kpn_apply.bwd_weights_cuda(b[0], b[2], k) for b in bufs])
        probe[f"moved64_{stack}"] = _bwd_work("bwd_weights", *bufs[0], k)["moved64"]
        del bufs
    probe[BWD_STACK] = timings["bwd_weights"][("train", 0)]["ms"]
    probe[3] = timings["bwd_weights"][("train", None)]["ms"]
    log("[train-kernels] kpn_apply.bwd_weights at the training batch, slot 0 of a stack of S "
        "channels: " + ", ".join(f"S={s} {probe[s] * 1e3:.1f} us" for s in (3, 8, 16, BWD_STACK))
        + f" (64 B blocks moved at S=8, 16: {probe['moved64_8'] / 1e6:.1f}, "
        f"{probe['moved64_16'] / 1e6:.1f} MB) | {card['smi']}")
    torch.cuda.empty_cache()
    return {e: {**t[("train", 0)], "max_abs_err": worst[e],
                "stride_probe_ms": {s: probe[s] for s in (3, 8, 16, BWD_STACK)} if e == "bwd_weights" else None,
                "cases": {f"{p} {_bwd_label(s)}": v for (p, s), v in t.items()}}
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
        expect_launches("train-parity step", read_launches(), kpn_apply=8, kpn_apply_bwd_weights=8,
                        kpn_softmax=8, bias_act=EPILOGUES["base-16 depth-2"])
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


def phase_train(frame: dict, card: dict, profile: bool = False, parent_csrc=None) -> dict:
    """kpn-hq trained through the user's commands: synth-data -> prepare-data
    -> train (20 steps, then resumed to 30) -> denoise --checkpoint --ema on
    the 1080p frame; then a fixed-batch overfit check and ms per step of
    kpn-hq and flagship-hq through make_train_step. With `profile`, device
    time by kernel of each step, its copies and busy time; with
    `parent_csrc` too, kpn-hq's step again with that tree's planar d_w
    (planar_backward): its softmax backward's 8 transposing copies show as
    8 more copy launches a step."""
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
                    kpn_apply_bwd_weights=8 * TRAIN_STEPS, kpn_softmax=8 * TRAIN_STEPS + per_eval,
                    bias_act=EPILOGUES["kpn-hq"] * (TRAIN_STEPS + per_eval // 8))
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
                    kpn_apply_bwd_weights=8 * resumed, kpn_softmax=8 * resumed,
                    bias_act=EPILOGUES["kpn-hq"] * resumed)
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
    expect_launches("cli denoise --checkpoint", read_launches(), kpn_apply=8, kpn_softmax=8,
                    bias_act=EPILOGUES["kpn-hq"])
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
    # flagship-hq also in fp32 (TF32 off), beside the CPU comparison of both
    # packages on the same recipe (tests/torch_flagship_hq_recipe.py)
    for preset, dtype, k1, n in (("kpn-hq", None, 8, OVERFIT_STEPS),
                                 ("flagship-hq", None, 0, TIMED_STEPS),
                                 ("flagship-hq", "float32", 0, TIMED_STEPS)):
        mcfg = config.validate_channels(config.PRESETS[preset]).model
        if dtype:
            mcfg = dataclasses.replace(mcfg, compute_dtype=dtype)
        label = f"{preset} {mcfg.compute_dtype}"
        tcfg = dataclasses.replace(cfg.train, learning_rate=OVERFIT_LR, warmup_steps=0,
                                   schedule="constant")
        state = train_lib.create_state(mcfg, tcfg, seed=0)
        step = train_lib.make_train_step(mcfg, tcfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with full_fp32() if dtype == "float32" else contextlib.nullcontext():
            losses, times = _steps_timed(state, step, batch, n)
        expect_launches(f"{label} train steps", read_launches(), n, kpn_apply=k1,
                        kpn_apply_bwd_weights=k1, kpn_softmax=k1, bias_act=EPILOGUES[preset])
        ms = statistics.median(times[TRAIN_WARMUP:])
        res[label] = {"ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "first_loss": losses[0], "last_loss": losses[-1], "steps": n}
        log(f"[train] {label} make_train_step, batch {TRAIN_BATCH}, crop {TRAIN_CROP}, one "
            f"fixed batch on the card, Adam lr {OVERFIT_LR} constant: {ms:.2f} ms/step median of "
            f"{n - TRAIN_WARMUP} (min {min(times[TRAIN_WARMUP:]):.2f}, max "
            f"{max(times[TRAIN_WARMUP:]):.2f}; host clock, each step closed by reading its loss), "
            f"{TRAIN_BATCH / ms * 1e3:.1f} samples/s, {px / ms / 1e3:.2f} Mpx/s, peak "
            f"{res[label]['peak_gib']:.2f} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f} "
            f"({losses[-1] / losses[0]:.3f}x; at step 30 {losses[29] / losses[0]:.3f}x); K1 launches per step {k1} forward, {k1} backward "
            f"| {card['smi']}")
        log(f"[train] {label} fixed-batch loss curve: " + " ".join(f"{v:.4f}" for v in losses))
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{label}: non-finite loss {losses}")
        if preset == "kpn-hq" and not losses[-1] < 0.5 * losses[0]:
            raise AssertionError(f"kpn-hq overfit: loss {losses[0]} -> {losses[-1]}, not below half")
        if profile:
            prof = profile_frames(f"{label} train step", lambda: step(state, batch), card)
            if parent_csrc and k1:
                from deepdenoiser_tpu_torch.ops import kpn_apply

                mine = kpn_apply.bwd_weights_cuda
                kpn_apply.bwd_weights_cuda = planar_backward(parent_csrc)["bwd_weights"]
                try:
                    planar = profile_frames(f"{label} train step, d_w planar ({parent_csrc})",
                                            lambda: step(state, batch), card)
                finally:
                    kpn_apply.bwd_weights_cuda = mine
                log(f"[train] {label} train step, copies a step: {prof['copy_launches']:.2f} "
                    f"launches, {prof['copy_ms']:.3f} ms with d_w in the head's layout; "
                    f"{planar['copy_launches']:.2f}, {planar['copy_ms']:.3f} ms with the planar "
                    f"d_w of {parent_csrc}; device busy {prof['busy_ms']:.3f} against "
                    f"{planar['busy_ms']:.3f} ms a step | {card['smi']}")
                if round(planar["copy_launches"] - prof["copy_launches"]) != k1:
                    raise AssertionError(f"{label}: {prof['copy_launches']} copies a step, "
                                         f"{planar['copy_launches']} with the planar d_w; want "
                                         f"{k1} fewer")
        del state, step
        torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------------------
# synthesis: the traced Monte-Carlo frame and batches made on the card
# --------------------------------------------------------------------------

MC_GT_SPP, MC_SPP = 1024, 4  # bench.py's MC column: make_scene(0), GT 1024 spp, noisy 4 spp
MC_CHECK_H, MC_CHECK_W, MC_CHECK_SPP = 96, 128, 64  # the card against the port on the CPU
MC_FLIP_SHARE = 0.002  # at most 0.2 % of pixels may flip (a silhouette or checker edge)
MC_RMS_RATIO = 1.5  # RMS(card - CPU) against RMS(CPU - CPU), two independent estimates
# bf16 against fp32 for flagship-mc on the traced frame: its output sits
# ~19 dB over the 4-spp input against a 1024-spp GT, where bf16 rounding
# shows; the JAX package's own bf16 runs 0.097 dB from its fp32 at 540x960
# (the port's 0.057; tests/torch_flagship_mc_bf16_gap.py on the CPU). kpn-hq
# keeps GAIN_TOL_DB on the same frame
MC_FLAGSHIP_GAIN_TOL_DB = 0.15
MC_DETERMINISTIC = ("normal", "depth", "alpha", "emission", "environment", "diffuse_color",
                    "glossy_color", "subsurface_color", "transmission_color")
DEVICE_BATCH_STEPS = 10  # make_train_step steps fed by training_batch(family="mixed-mc")


def _holdout_frames(h: int, w: int, path: Path) -> Path:
    """bench.py's two holdout families at h x w with its Gaussian noise
    (add_mc_noise(spp=4, seed=1)): {family: (noisy passes, clean combined,
    seconds)}, pickled to `path`, which it returns. numpy on the host; run
    in a worker process beside the card. The frames (about 0.8 GB at 1080p)
    go through a file, not the pool's pipe: the main process's thread that
    unpickles a result holds the GIL, and would stall the timed frames of
    whichever phase runs when the result arrives."""
    from deepdenoiser_tpu_torch.data import synthetic, synthetic_boxes, synthetic_spheres

    out = {}
    for fam, mod in (("spheres", synthetic_spheres), ("boxes", synthetic_boxes)):
        t0 = time.perf_counter()
        clean = mod.generate_clean_passes(h, w, seed=0)
        out[fam] = (synthetic.add_mc_noise(clean, spp=4, seed=1), clean["combined"],
                    time.perf_counter() - t0)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    return path


@functools.lru_cache(maxsize=1)
def _load_holdouts(path: Path) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def _near_edges(ref: dict) -> torch.Tensor:
    """(H, W) bool: pixels within 1 px of an object silhouette or a checker
    edge of `ref`: a change of alpha or of albedo between neighbours."""
    import torch.nn.functional as F

    alpha, albedo = ref["alpha"][..., 0], ref["diffuse_color"]
    edge = torch.zeros_like(alpha, dtype=torch.bool)
    for dim in (0, 1):
        jump = (alpha.diff(dim=dim) != 0) | (albedo.diff(dim=dim).abs().amax(-1) > 1e-3)
        n = jump.shape[dim]
        edge.narrow(dim, 0, n).logical_or_(jump)
        edge.narrow(dim, 1, n).logical_or_(jump)
    return F.max_pool2d(edge.float()[None, None], 3, stride=1, padding=1)[0, 0] > 0


def _deterministic_flips(what: str, got: dict, ref: dict) -> int:
    """The deterministic buffers of two renders of one scene agree within
    1e-5 + 1e-5*|ref| except at flipped pixels (a silhouette test or a
    checker floor that rounds the other way): at most MC_FLIP_SHARE of the
    pixels, each within 1 px of an edge of `ref`. Returns the flips."""
    bad = torch.zeros_like(ref["alpha"][..., 0], dtype=torch.bool)
    for name in MC_DETERMINISTIC:
        r = ref[name]
        bad |= ((got[name] - r).abs() > 1e-5 + 1e-5 * r.abs()).any(-1)
    flips, off_edge = int(bad.sum()), int((bad & ~_near_edges(ref)).sum())
    if flips > MC_FLIP_SHARE * bad.numel() or off_edge:
        raise AssertionError(f"{what}: {flips} pixels differ ({off_edge} away from any edge) "
                             f"of {bad.numel()}")
    return flips


def _mc_card_against_cpu() -> dict:
    """The tracer on the card against the port on the CPU at a small size:
    the deterministic buffers under the flip bar on an emitter scene (0)
    and one without (5); the direct and indirect estimates within
    Monte-Carlo error: RMS(card - CPU) <= MC_RMS_RATIO * RMS of two
    independent CPU estimates, at MC_CHECK_SPP samples."""
    from deepdenoiser_tpu_torch.data import mc_tracer
    from deepdenoiser_tpu_torch.data.draws import seeded

    res = {}
    for seed in (0, 5):
        renders = {}
        for name, dev, key in (("card", "cuda", 1), ("cpu", "cpu", 1), ("cpu2", "cpu", 2)):
            scene = mc_tracer.make_scene(seed, device=dev)
            out = mc_tracer.render(scene, MC_CHECK_H, MC_CHECK_W, MC_CHECK_SPP, seeded(key, dev))
            renders[name] = {k: v.cpu() for k, v in out.items()}
        card, cpu, cpu2 = renders["card"], renders["cpu"], renders["cpu2"]
        flips = _deterministic_flips(f"mc scene {seed} card vs CPU", card, cpu)
        ratios = {}
        for p in ("diffuse_direct", "diffuse_indirect"):
            spread = float((cpu[p] - cpu2[p]).pow(2).mean().sqrt())
            ratios[p] = max(float((card[p] - c[p]).pow(2).mean().sqrt()) for c in (cpu, cpu2)
                            ) / spread
            if not ratios[p] <= MC_RMS_RATIO:
                raise AssertionError(f"mc scene {seed}: {p} card vs CPU RMS {ratios[p]:.3f} x "
                                     f"the CPU's own spread (limit {MC_RMS_RATIO})")
        res[seed] = {"flips": flips, "rms_ratio": ratios}
    return res


def phase_mc(frame: dict, card: dict, holdouts) -> dict:
    """bench.py's MC column on the card: make_scene(0) traced at 1080p (GT
    1024 spp, timed; noisy 4 spp), checked against the CPU at a small size,
    and denoised by kpn-hq and flagship-mc through make_joint_frame_denoiser;
    both models' gains on the four bench.py families."""
    from deepdenoiser_tpu_torch import transforms
    from deepdenoiser_tpu_torch.data import mc_tracer

    res = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gt = mc_tracer.generate_clean_passes(FRAME_H, FRAME_W, seed=0, spp=MC_GT_SPP)
    torch.cuda.synchronize()
    res["gt_s"] = time.perf_counter() - t0
    res["gt_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    noisy = mc_tracer.generate_noisy_passes(FRAME_H, FRAME_W, seed=0, spp=MC_SPP,
                                            sample_seed=MC_SPP)
    torch.cuda.synchronize()
    res["noisy_s"] = time.perf_counter() - t0
    for what, f in (("GT", gt), ("noisy", noisy)):
        check_frame(f"mc {what}", f)
        err = float((f["combined"] - transforms.recompose(f)).abs().max())
        if not err <= 2e-5:
            raise AssertionError(f"mc {what}: combined differs from the recomposition by {err}")
    log(f"[mc] make_scene(0) traced at {FRAME_H}x{FRAME_W}: GT {MC_GT_SPP} spp in "
        f"{res['gt_s']:.2f} s ({res['gt_s'] / MC_GT_SPP * 1e3:.3f} ms a sample; host clock around "
        f"a synchronize; peak {res['gt_peak_gib']:.2f} GiB), noisy {MC_SPP} spp in "
        f"{res['noisy_s']:.3f} s; combined == recompose and finite | {card['smi']}")
    t0 = time.perf_counter()
    res["check"] = _mc_card_against_cpu()
    log(f"[mc] card against the port on the CPU at {MC_CHECK_H}x{MC_CHECK_W}, {MC_CHECK_SPP} spp "
        f"({time.perf_counter() - t0:.1f} s): " + "; ".join(
            f"scene {seed}: {c['flips']} flipped pixels (limit "
            f"{int(MC_FLIP_SHARE * MC_CHECK_H * MC_CHECK_W)}, all at edges), RMS card-CPU / "
            f"CPU-CPU " + ", ".join(f"{p} {r:.3f}" for p, r in c["rms_ratio"].items())
            for seed, c in res["check"].items()) + f" (limit {MC_RMS_RATIO})")

    t0 = time.perf_counter()
    hold = _load_holdouts(holdouts.result())
    dev = torch.device("cuda")
    others = {"fourier": frame}
    others.update({fam: {"noisy": n, "clean": {"combined": c}} for fam, (n, c, _) in hold.items()})
    others = {fam: ({k: torch.as_tensor(v, device=dev) for k, v in f["noisy"].items()},
                    torch.as_tensor(f["clean"]["combined"], device=dev))
              for fam, f in others.items()}
    others["mc"] = (noisy, gt["combined"])
    log(f"[mc] holdout frames at 1080p (numpy, a worker process started with the script): "
        + ", ".join(f"{fam} {t:.1f} s" for fam, (_, _, t) in hold.items())
        + f"; waited {time.perf_counter() - t0:.1f} s here")
    mc_frame = {"clean": gt, "noisy": noisy}
    for preset, weights, k1, tol in (
            ("kpn-hq", "kpn_hq_ema_f16.npz", 8, GAIN_TOL_DB),
            ("flagship-mc", "flagship_mc_ema_f16.npz", 0, MC_FLAGSHIP_GAIN_TOL_DB)):
        res[preset] = phase_preset(preset, weights, mc_frame, card, kernel_launches_per_frame=k1,
                                   check_fp32=True, timed_frames=5, gain_tol=tol, cli=False,
                                   label=f"mc {preset}", other_frames=others)
    log("[mc] PSNR gain at 1080p (tonemapped, bf16): " + "; ".join(
        f"{preset} " + ", ".join(f"{fam} {g:.4f} dB" for fam, g in res[preset]["other_gains_db"].items())
        for preset in ("kpn-hq", "flagship-mc")))
    # the bench phase's mc family, in host memory until then so that the
    # peaks of phases 20-23 measure only their own allocations
    res["frame"] = ({k: v.cpu() for k, v in noisy.items()}, gt["combined"].cpu())
    del others, mc_frame, gt, noisy
    torch.cuda.empty_cache()
    return res


def phase_device_batch(card: dict, train_res: dict) -> dict:
    """training_batch on the card: ms a batch (CUDA events) and peak memory
    for each family at the training recipe's batch and crop; then the
    kpn-hq train step (phase 18's recipe) fed only by mixed-mc batches: ms a
    step with the synthesis and for the step alone, K1 and d_w launches a
    step, finite loss."""
    from deepdenoiser_tpu_torch import config, transforms
    from deepdenoiser_tpu_torch.data import synthetic_device
    from deepdenoiser_tpu_torch.training import train as train_lib

    gen = torch.Generator(device="cuda").manual_seed(0)

    def make(family):
        return synthetic_device.training_batch(gen, TRAIN_BATCH, TRAIN_CROP, "joint", family)

    res = {"families": {}}
    want = {"x": transforms.joint_input_channels(), "y": transforms.joint_output_channels()}
    for family in synthetic_device.FAMILIES:
        b = make(family)  # warm-up, checked
        for k, c in want.items():
            if (tuple(b[k].shape) != (TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, c)
                    or b[k].device.type != gen.device.type or not torch.isfinite(b[k]).all()):
                raise AssertionError(f"training_batch {family}: {k} {tuple(b[k].shape)} on "
                                     f"{b[k].device}, finite {bool(torch.isfinite(b[k]).all())}")
        del b
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n = 3 if "mc" in family else 10
        ms = cuda_ms(lambda: make(family), iters=n, warmup=0)
        res["families"][family] = {"ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                                   "batches": n}
    log(f"[device-batch] training_batch({TRAIN_BATCH}, {TRAIN_CROP}, joint) on the card, ms a "
        f"batch (CUDA events) and peak: " + ", ".join(
            f"{f} {r['ms']:.2f} ms {r['peak_gib']:.3f} GiB (of {r['batches']})"
            for f, r in res["families"].items()) + f" | {card['smi']}")

    cfg = _train_config()
    mcfg = config.validate_channels(cfg).model
    state = train_lib.create_state(mcfg, cfg.train, seed=0)
    step = train_lib.make_train_step(mcfg, cfg.train)
    for _ in range(2):  # warm-up
        state, mets = step(state, make("mixed-mc"))
    float(mets["loss"])
    reset_launches()
    losses, times = [], []
    for _ in range(DEVICE_BATCH_STEPS):
        t0 = time.perf_counter()
        state, mets = step(state, make("mixed-mc"))
        losses.append(float(mets["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    expect_launches("device-batch train steps", launches, DEVICE_BATCH_STEPS, kpn_apply=8,
                    kpn_apply_bwd_weights=8, kpn_softmax=8, bias_act=EPILOGUES["kpn-hq"])
    step_losses, step_times = _steps_timed(state, step, make("mixed-mc"), DEVICE_BATCH_STEPS)
    if not all(math.isfinite(v) for v in losses + step_losses):
        raise AssertionError(f"device-batch train: non-finite loss {losses} {step_losses}")
    res.update(ms=statistics.median(times), step_ms=statistics.median(step_times),
               launches={k: v / DEVICE_BATCH_STEPS for k, v in launches.items()}, losses=losses)
    log(f"[device-batch] kpn-hq make_train_step fed by training_batch(mixed-mc) on the card, "
        f"batch {TRAIN_BATCH}, crop {TRAIN_CROP}, lr {cfg.train.learning_rate} with "
        f"{cfg.train.warmup_steps} warm-up steps: synthesis + step {res['ms']:.2f} ms, the step "
        f"alone {res['step_ms']:.2f} ms (medians of {DEVICE_BATCH_STEPS}, host clock, each step "
        f"closed by reading its loss); phase 18: `train` {train_res['cli_ms']:.2f} ms, "
        f"make_train_step on a fixed batch {train_res['kpn-hq bfloat16']['ms']:.2f} ms; launches "
        f"a step: kpn_apply {res['launches']['kpn_apply']:g}, bwd_weights "
        f"{res['launches']['kpn_apply_bwd_weights']:g}; loss " + " ".join(f"{v:.4f}" for v in losses)
        + f" | {card['smi']}")
    del state, step
    torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------------------
# multi-device: band-parallel frames, frame batches and data-parallel
# training, every path on the one card
# --------------------------------------------------------------------------

MD_BANDS = (2, 4)  # spatial meshes ["cuda:0"] * n for the banded kpn-hq frame
MD_GROUP_BANDS = 4  # the banded flagship-max group frame
MD_BATCH_FRAMES = 4  # frames through make_batch_frame_denoiser on a 4-way data mesh
MD_TIMED_FRAMES = 5
MD_TOL = 1e-4  # x max|ref| per pass, fp32 (TF32 off): banded == the certified whole frame
DP_RANKS, DP_STEPS, DP_CLI_STEPS = 2, 3, 10
DP_REL = 1e-5  # loss and grad_norm: N ranks against the one-rank global step
DP_ABS = 2e-6  # parameters: the rank invariant of tests/test_train.py:31-50, and 1e-3 lr,
# where the gradient is resolved (|g| > 1e-5 of its norm at every step, phase 17's
# criterion); where it is at rounding level Adam's m/sqrt(v) is decided by rounding
# (ROADMAP.md §3 (g)), and such elements are held to 2 x the summed learning rate, as in
# phase 17. Both sides run cuDNN's deterministic algorithms: with the default ones the
# one-rank step itself differs from run to run, and so did the gap (1.25e-7 to 2.70e-7)
DP_ALLREDUCE_REPS = 10
DP_TIMEOUT_S = 300  # the spawned ranks, and the launcher's `train`, are stopped after this


def _md_mesh(n: int, axis: str):
    from deepdenoiser_tpu_torch.parallel import mesh

    return mesh.make_mesh(n, axis, devices=["cuda:0"] * n)


def _timed_frames(den, frame_dev, n: int) -> tuple:
    """(median ms, min, max, peak GiB, launches) over n frames after two
    warm-up frames, launch counts set to 0 just before."""
    for _ in range(2):
        den(frame_dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times = time_frames(lambda: den(frame_dev), n)
    return (statistics.median(times), min(times), max(times),
            torch.cuda.max_memory_allocated() / 2**30, read_launches())


def _dp_rank(rank: int, world: int, init_method: str, out_dir: str, params: dict, batch: dict,
             steps: int) -> None:
    """One data-parallel rank on cuda:0 (spawned): `steps` kpn-hq train
    steps in fp32 (TF32 off, deterministic convs) on its share of the global
    batch; the launches of K1 and d_w a step; the time of the gradient
    all-reduce alone."""
    from deepdenoiser_tpu_torch import config, weights_io
    from deepdenoiser_tpu_torch.parallel import dist
    from deepdenoiser_tpu_torch.training import train as train_lib

    group = dist.init(rank, world, init_method, device="cuda")
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True  # as the one-rank reference runs
        cfg = _train_config()
        mcfg = dataclasses.replace(config.validate_channels(cfg).model, compute_dtype="float32")
        state = train_lib.create_state(mcfg, cfg.train, params=weights_io.unflatten(params))
        step = train_lib.make_train_step(mcfg, cfg.train, group)
        per = TRAIN_BATCH // world
        mine = {k: torch.from_numpy(v[rank * per : (rank + 1) * per]).to(group.device)
                for k, v in batch.items()}
        mets, launches = [], []
        for _ in range(steps):
            reset_launches()
            state, out = step(state, mine)
            mets.append({k: float(v) for k, v in out.items()})
            launches.append(read_launches())
        flat = torch.cat([p.detach().reshape(-1) for p in state.model.parameters()])
        times = []
        for _ in range(DP_ALLREDUCE_REPS + 2):
            buf = torch.ones_like(flat)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            group.all_reduce_mean_(buf)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.save({"mets": mets, "launches": launches, "params": flat.cpu(),
                    "backend": group.backend, "allreduce_ms": times[2:],
                    "allreduce_bytes": flat.numel() * 4},
                   Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.shutdown(group)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_multi_device(frame: dict, card: dict) -> dict:
    """The multi-device paths, each on the one card: band-parallel kpn-hq
    frames over ["cuda:0"] * n (n = 2, 4) against the certified whole
    frame; the banded flagship-max group frame; a frame batch over a 4-way
    data mesh; data-parallel training on 2 gloo ranks (make_train_step
    against the one-rank global step, then `train` under
    torch.distributed.run and `denoise --checkpoint` in one process)."""
    import shutil

    import numpy as np

    from deepdenoiser_tpu_torch import config, weights_io
    from deepdenoiser_tpu_torch.data import exr, loader, synthetic
    from deepdenoiser_tpu_torch.inference import pipeline, sequence
    from deepdenoiser_tpu_torch.parallel import halo
    from deepdenoiser_tpu_torch.training import train as train_lib

    res = {"bands": {}}
    clean_c, noisy_c = _frame_on_card(frame)
    frame_dev = _fp32_frame(frame)

    # 1. band-parallel kpn-hq frames
    cfg = config.validate_channels(config.PRESETS["kpn-hq"])
    params = weights_io.load_release_params(ROOT / "weights" / "kpn_hq_ema_f16.npz")
    spatial = dataclasses.replace(cfg.infer, spatial_shard=True)
    spatial32 = dataclasses.replace(spatial, compute_dtype="float32")
    whole, wgrid = pipeline.make_joint_frame_denoiser(cfg.model, spatial, FRAME_H, FRAME_W, params)
    ms, lo, hi, peak, launches = _timed_frames(whole, frame_dev, MD_TIMED_FRAMES)
    expect_launches("kpn-hq whole frame, certified halo", launches, MD_TIMED_FRAMES, kpn_apply=8,
                    kpn_softmax=8, bias_act=EPILOGUES["kpn-hq"])
    whole_mpx = wgrid.net_h * wgrid.net_w / 1e6
    res["whole"] = {"ms": ms, "peak_gib": peak, "mpx": whole_mpx,
                    "gain_db": _gain_db(whole(frame_dev)["combined"], noisy_c, clean_c)}
    del whole
    with full_fp32():
        ref32 = pipeline.make_joint_frame_denoiser(cfg.model, spatial32, FRAME_H, FRAME_W,
                                                   params)[0](frame_dev)
    log(f"[multi-device] kpn-hq 1080p whole frame, certified halo {wgrid.halo}: network input "
        f"{wgrid.net_h}x{wgrid.net_w} ({whole_mpx:.2f} Mpx), {ms:.2f} ms/frame median of "
        f"{MD_TIMED_FRAMES} (min {lo:.2f}, max {hi:.2f}), peak {peak:.2f} GiB | {card['smi']}")
    for n in MD_BANDS:
        mesh = _md_mesh(n, "spatial")
        grid, b = halo.plan_bands(FRAME_H, FRAME_W, n, wgrid.halo, 8)
        shape = (1, b + 2 * grid.halo, grid.tile_w + 2 * grid.halo, cfg.model.in_channels)
        mpx = n * shape[1] * shape[2] / 1e6
        den, _ = pipeline.make_joint_frame_denoiser(cfg.model, spatial, FRAME_H, FRAME_W, params,
                                                    mesh=mesh)
        ms, lo, hi, peak, launches = _timed_frames(den, frame_dev, MD_TIMED_FRAMES)
        expect_launches(f"kpn-hq {n} bands", launches, MD_TIMED_FRAMES, kpn_apply=8 * n,
                        kpn_softmax=8 * n, bias_act=EPILOGUES["kpn-hq"] * n)
        out = den(frame_dev)
        check_frame(f"kpn-hq {n} bands", out)
        gain = _gain_db(out["combined"], noisy_c, clean_c)
        del den, out
        with full_fp32():
            den32, _ = pipeline.make_joint_frame_denoiser(cfg.model, spatial32, FRAME_H, FRAME_W,
                                                          params, mesh=mesh)
            reset_launches()
            out32 = den32(frame_dev)
            torch.cuda.synchronize()
            expect_launches(f"kpn-hq {n} bands fp32", read_launches(), kpn_apply=8 * n,
                            kpn_softmax=8 * n, bias_act=EPILOGUES["kpn-hq"] * n)
        err = frames_agree(f"kpn-hq {n} bands fp32 vs the whole frame", out32, ref32, MD_TOL)
        gain32 = _gain_db(out32["combined"], noisy_c, clean_c)
        del den32, out32
        torch.cuda.empty_cache()
        if gain <= 0 or abs(gain - gain32) > GAIN_TOL_DB:
            raise AssertionError(f"kpn-hq {n} bands: bf16 gain {gain:.4f} dB, fp32 {gain32:.4f}")
        res["bands"][n] = {"ms": ms, "min": lo, "max": hi, "peak_gib": peak, "band": b,
                           "hp": grid.halo, "band_input": shape, "mpx": mpx,
                           "launches_per_frame": launches["kpn_apply"] / MD_TIMED_FRAMES,
                           "fp32_err": err, "gain_db": gain, "fp32_gain_db": gain32}
        log(f"[multi-device] kpn-hq 1080p in {n} bands on ['cuda:0']*{n}: band {b} rows, halo "
            f"{grid.halo}, band input {shape} ({mpx:.2f} Mpx against {whole_mpx:.2f} whole), "
            f"{ms:.2f} ms/frame median of {MD_TIMED_FRAMES} (min {lo:.2f}, max {hi:.2f}), peak "
            f"{peak:.2f} GiB (whole frame {res['whole']['ms']:.2f} ms, "
            f"{res['whole']['peak_gib']:.2f} GiB); fp32 banded vs whole max|d|/max|ref| "
            f"{err:.2e} (limit {MD_TOL:g}); gain {gain:.4f} dB (fp32 {gain32:.4f}, whole "
            f"{res['whole']['gain_db']:.4f}); kpn_apply {launches['kpn_apply'] / MD_TIMED_FRAMES:g} "
            f"a frame | {card['smi']}")
    del ref32

    # 2. the banded flagship-max group frame, fused ingest
    gcfg = config.validate_channels(config.PRESETS["flagship-max"])
    gparams = weights_io.load_release_params(ROOT / "weights" / "kpn_ema_f16.npz")
    gicfg = dataclasses.replace(gcfg.infer, use_pallas_ingest=True, spatial_shard=True)
    n = MD_GROUP_BANDS
    gden, _ = pipeline.make_group_frame_denoiser(gcfg.model, gicfg, FRAME_H, FRAME_W, gparams,
                                                 mesh=_md_mesh(n, "spatial"))
    ms, lo, hi, peak, launches = _timed_frames(gden, frame_dev, MD_TIMED_FRAMES)
    expect_launches(f"flagship-max {n} bands", launches, MD_TIMED_FRAMES, kpn_apply=2 * n,
                    kpn_softmax=2 * n, group_encode=1, bias_act=EPILOGUES["flagship-max"] * n)
    gain = _gain_db(gden(frame_dev)["combined"], noisy_c, clean_c)
    del gden
    with full_fp32():
        g32 = dataclasses.replace(gicfg, compute_dtype="float32")
        outs = {}
        for key, mesh in (("bands", _md_mesh(n, "spatial")), ("whole", None)):
            den, _ = pipeline.make_group_frame_denoiser(gcfg.model, g32, FRAME_H, FRAME_W, gparams,
                                                        mesh=mesh)
            outs[key] = den(frame_dev)
            del den
        torch.cuda.synchronize()
    gerr = frames_agree(f"flagship-max {n} bands fp32 vs the whole frame", outs["bands"],
                        outs["whole"], MD_TOL)
    del outs
    torch.cuda.empty_cache()
    if gain <= 0:
        raise AssertionError(f"flagship-max {n} bands: no gain ({gain})")
    res["group"] = {"bands": n, "ms": ms, "peak_gib": peak, "fp32_err": gerr, "gain_db": gain,
                    "launches": {k: v / MD_TIMED_FRAMES for k, v in launches.items() if v}}
    log(f"[multi-device] flagship-max 1080p group frame in {n} bands, fused ingest: "
        f"{ms:.2f} ms/frame median of {MD_TIMED_FRAMES} (min {lo:.2f}, max {hi:.2f}), peak "
        f"{peak:.2f} GiB; launches a frame {res['group']['launches']}; fp32 banded vs whole "
        f"{gerr:.2e} (limit {MD_TOL:g}); gain {gain:.4f} dB | {card['smi']}")

    # 3. a frame batch over a 4-way data mesh
    clean = frame["clean"]
    frames = [frame["noisy"]] + [synthetic.add_mc_noise(clean, spp=4, seed=2 + i)
                                 for i in range(MD_BATCH_FRAMES - 1)]
    batch = {k: torch.from_numpy(np.stack([np.asarray(f[k], np.float32) for f in frames])).to("cuda")
             for k in frames[0]}
    del frames
    bden, _ = sequence.make_batch_frame_denoiser(cfg.model, cfg.infer, _md_mesh(4, "data"),
                                                 FRAME_H, FRAME_W, params)
    one, _ = pipeline.make_joint_frame_denoiser(cfg.model, cfg.infer, FRAME_H, FRAME_W, params)
    bden(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    got = bden(batch)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    expect_launches("kpn-hq frame batch", launches, MD_BATCH_FRAMES, kpn_apply=8, kpn_softmax=8,
                    bias_act=EPILOGUES["kpn-hq"])
    batch_peak = torch.cuda.max_memory_allocated() / 2**30
    if tuple(got.shape) != (MD_BATCH_FRAMES, FRAME_H, FRAME_W, 3) or not torch.isfinite(got).all():
        raise AssertionError(f"frame batch: {tuple(got.shape)}")
    berr = 0.0
    for i in range(MD_BATCH_FRAMES):
        want = one({k: v[i] for k, v in batch.items()})["combined"]
        berr = max(berr, frames_agree(f"frame batch, frame {i}", {"combined": got[i]},
                                      {"combined": want}, MD_TOL))
    del bden, one, got, batch
    torch.cuda.empty_cache()
    res["batch"] = {"frames": MD_BATCH_FRAMES, "ms_per_frame": batch_ms / MD_BATCH_FRAMES,
                    "peak_gib": batch_peak, "err": berr, "launches": launches["kpn_apply"]}
    log(f"[multi-device] kpn-hq batch of {MD_BATCH_FRAMES} 1080p frames on a 4-way data mesh "
        f"['cuda:0']*4: {batch_ms:.2f} ms the batch, {batch_ms / MD_BATCH_FRAMES:.2f} ms/frame "
        f"(host clock around a synchronize), peak {batch_peak:.2f} GiB; each frame against its "
        f"own one-frame denoise {berr:.2e} (limit {MD_TOL:g}); kpn_apply {launches['kpn_apply']} "
        f"| {card['smi']}")

    # 4a. make_train_step on 2 gloo ranks sharing the card against the
    # one-rank step on the global batch
    tcfg = _train_config()
    shards_dir = WORK / "train_shards"
    raw = {k: v.to("cuda") for k, v in loader.make_dataset(shards_dir / "train", tcfg.data,
                                                           training=False)[(0, 0)].items()}
    enc = loader.make_batch_encoder(tcfg.data)(raw)
    gbatch = {k: enc[k].cpu().numpy() for k in ("x", "y")}
    mcfg = dataclasses.replace(config.validate_channels(tcfg).model, compute_dtype="float32")
    start = train_lib.create_state(mcfg, tcfg.train, seed=0)
    flat_params = weights_io.flatten(weights_io.params_from_state_dict(
        {k: v.cpu() for k, v in start.model.state_dict().items()}))
    out_dir = WORK / "dp_ranks"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.start_processes(
        _dp_rank, args=(DP_RANKS, f"file://{out_dir / 'rendezvous'}", str(out_dir), flat_params,
                        gbatch, DP_STEPS),
        nprocs=DP_RANKS, join=False, start_method="spawn")
    while not ctx.join(timeout=1.0):  # raises as soon as a rank fails
        if time.perf_counter() - t0 > DP_TIMEOUT_S:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"DP ranks still running after {DP_TIMEOUT_S} s")
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(DP_RANKS)]
    for r in ranks:
        for lc in r["launches"]:
            expect_launches("DP rank train step", lc, kpn_apply=8, kpn_apply_bwd_weights=8,
                            kpn_softmax=8, bias_act=EPILOGUES["kpn-hq"])
    if not torch.equal(ranks[0]["params"], ranks[1]["params"]) or ranks[0]["mets"] != ranks[1]["mets"]:
        raise AssertionError("DP ranks hold different parameters or metrics")
    step = train_lib.make_train_step(mcfg, tcfg.train)
    tb = {k: torch.from_numpy(v).to("cuda") for k, v in gbatch.items()}
    # the same global batch with its halves swapped: the one-rank step in
    # another summation order, the scale of what rounding alone moves
    swapped = {k: torch.cat([v[TRAIN_BATCH // 2:], v[:TRAIN_BATCH // 2]]) for k, v in tb.items()}
    control = train_lib.create_state(mcfg, tcfg.train, params=weights_io.unflatten(flat_params))
    resolved = None
    with full_fp32(), deterministic_convs():
        for got in ranks[0]["mets"]:
            start, want = step(start, tb)
            for k in ("loss", "grad_norm"):
                if not abs(got[k] - float(want[k])) <= DP_REL * abs(float(want[k])):
                    raise AssertionError(f"DP step {k}: {got[k]} vs one rank {float(want[k])}")
            g = torch.cat([p.grad.reshape(-1) for p in start.model.parameters()])
            big = (g.abs() > 1e-5 * g.norm()).cpu()
            resolved = big if resolved is None else resolved & big
            control, _ = step(control, swapped)
    one_flat = torch.cat([p.detach().reshape(-1) for p in start.model.parameters()]).cpu()
    swap_flat = torch.cat([p.detach().reshape(-1) for p in control.model.parameters()]).cpu()
    swap_resolved = float((swap_flat - one_flat).abs()[resolved].max())
    dp_gap = (ranks[0]["params"] - one_flat).abs()
    lr = tcfg.train.learning_rate
    lr_sum = sum(train_lib.learning_rate(tcfg.train, s) for s in range(DP_STEPS))
    over = int((dp_gap > 1e-3 * lr).sum())
    gap_resolved = float(dp_gap[resolved].max())
    if gap_resolved > min(DP_ABS, 1e-3 * lr) or float(dp_gap.max()) > 2 * lr_sum:
        raise AssertionError(f"DP parameters: max|d| {gap_resolved:.3e} where the gradient is "
                             f"resolved (limit {min(DP_ABS, 1e-3 * lr):.3e}), "
                             f"{float(dp_gap.max()):.3e} over all (limit {2 * lr_sum:.3e})")
    del start, control, step, tb, swapped, enc, raw
    torch.cuda.empty_cache()
    ar = ranks[0]["allreduce_ms"]
    res["dp_step"] = {"ranks": DP_RANKS, "backend": ranks[0]["backend"],
                      "max_param_gap": float(dp_gap.max()), "over_1e-3_lr": over,
                      "max_param_gap_resolved": gap_resolved, "resolved": int(resolved.sum()),
                      "swapped_halves_gap_resolved": swap_resolved,
                      "allreduce_ms": statistics.median(ar), "allreduce_mb": ranks[0]["allreduce_bytes"] / 1e6,
                      "launches_per_step": ranks[0]["launches"][0], "spawn_s": spawn_s}
    log(f"[multi-device] make_train_step, kpn-hq, batch {TRAIN_BATCH} ({TRAIN_BATCH // DP_RANKS} a rank), crop "
        f"{TRAIN_CROP}, fp32 (TF32 off, deterministic convs), {DP_RANKS} ranks on cuda:0 over "
        f"{ranks[0]['backend']}, "
        f"{DP_STEPS} steps: loss and grad_norm within rel {DP_REL:g} of the one-rank global step, "
        f"parameters max|d| {gap_resolved:.3e} over the {int(resolved.sum())} of "
        f"{one_flat.numel()} whose gradient is resolved (limit {min(DP_ABS, 1e-3 * lr):.3e}; "
        f"the one-rank step on the batch with its halves swapped {swap_resolved:.3e}), "
        f"{float(dp_gap.max()):.3e} "
        f"over all ({float(dp_gap.max()) / lr:.2e} lr, limit {2 * lr_sum / lr:g} lr; {over} "
        f"over 1e-3 lr); each rank a step: kpn_apply 8, "
        f"bwd_weights 8; all-reduce of the {ranks[0]['allreduce_bytes'] / 1e6:.1f} MB of fp32 "
        f"gradients {res['dp_step']['allreduce_ms']:.2f} ms median of {len(ar)} (host clock "
        f"around a synchronize; min {min(ar):.2f}, max {max(ar):.2f}); spawn and run "
        f"{spawn_s:.1f} s | {card['smi']}")
    del ranks

    # 4b. `train` under torch.distributed.run, 2 ranks, phase 18's recipe
    workdir = WORK / "dp_run"
    shutil.rmtree(workdir, ignore_errors=True)
    argv = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node",
            str(DP_RANKS), "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
            "-m", "deepdenoiser_tpu_torch.cli", "train", "--config", str(WORK / "train.json"),
            "--workdir", str(workdir), "--shards", str(shards_dir), "--steps", str(DP_CLI_STEPS)]
    t0 = time.perf_counter()
    # its own session, so a timeout stops the launcher and its ranks together
    proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=DP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise AssertionError(f"torch.distributed.run train still running after {DP_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    (WORK / "dp_train.log").write_text(stdout + stderr)
    if proc.returncode != 0:
        raise AssertionError(f"torch.distributed.run train: rc {proc.returncode}\n"
                             + (stdout + stderr)[-3000:])
    dist_line = next((ln for ln in stdout.splitlines() if ln.startswith("[dist]")), None)
    recs = _metrics(workdir / "metrics_train.jsonl")
    ckpts = sorted(int(p.name) for p in (workdir / "checkpoints").iterdir() if p.name.isdigit())
    if (dist_line is None or [r["step"] for r in recs] != list(range(1, DP_CLI_STEPS + 1))
            or ckpts != [DP_CLI_STEPS] or not all(math.isfinite(r["loss"]) for r in recs)):
        raise AssertionError(f"DP train: {dist_line}, steps {[r['step'] for r in recs]}, "
                             f"checkpoints {ckpts}")
    step_ms = [(b["time"] - a["time"]) * 1e3 for a, b in zip(recs[2:], recs[3:])]
    res["dp_cli"] = {"ms": statistics.median(step_ms), "wall_s": wall, "dist": dist_line,
                     "losses": [r["loss"] for r in recs]}
    log(f"[multi-device] torch.distributed.run --nproc_per_node {DP_RANKS} ... train, kpn-hq "
        f"batch {TRAIN_BATCH} ({TRAIN_BATCH // DP_RANKS} a rank), crop {TRAIN_CROP}, bf16, {DP_CLI_STEPS} steps in "
        f"{wall:.1f} s (process start included): {res['dp_cli']['ms']:.2f} ms/step median over "
        f"steps 4-{DP_CLI_STEPS} (host clock between rank 0's metric records); rank 0: "
        f"{dist_line}; checkpoints {ckpts}; loss " + " ".join(f"{v:.4f}" for v in
                                                         res["dp_cli"]["losses"])
        + f" | {card['smi']}")

    # 4c. the 2-rank checkpoint denoised by one process
    reset_launches()
    out_exr = WORK / "dp_denoised.exr"
    if _cli_quiet(["denoise", "--config", str(workdir / "config.json"), "--checkpoint",
                   str(workdir / "checkpoints"), "--ema", "--frame", str(frame["dir"]),
                   "--out", str(out_exr)]) != 0:
        raise AssertionError("cli denoise --checkpoint of the 2-rank run failed")
    torch.cuda.synchronize()
    expect_launches("denoise --checkpoint of the 2-rank run", read_launches(), kpn_apply=8,
                    kpn_softmax=8, bias_act=EPILOGUES["kpn-hq"])
    out = torch.from_numpy(exr.read_exr(out_exr))
    if tuple(out.shape) != (FRAME_H, FRAME_W, 3) or not torch.isfinite(out).all():
        raise AssertionError(f"denoise of the 2-rank checkpoint: {tuple(out.shape)}")
    log(f"[multi-device] denoise --checkpoint --ema of the {DP_RANKS}-rank run (step "
        f"{DP_CLI_STEPS}) in one process: 1080p frame finite, 8 kpn_apply launches")
    return res


# --------------------------------------------------------------------------
# release: the frozen TF goldens, kpn-hq's weights through a TF checkpoint,
# the pretraining recipe's loop and the release export
# --------------------------------------------------------------------------

RELEASE_STEPS, RELEASE_VAL_EVERY, RELEASE_LOG_EVERY = 20, 10, 5
RELEASE_TEACHER = "flagship-hq"
RELEASE_EXTRA = {"model", "mode", "val_psnr", "family"}


@contextlib.contextmanager
def _k1_in_validation(counts: list):
    """Appends K1's launches inside each call of the recipe's eval step
    (training/train.make_eval_step) to `counts`, so a recipe run's launches
    split into its steps' and its validation's."""
    from deepdenoiser_tpu_torch.ops import kpn_apply
    from deepdenoiser_tpu_torch.training import train as train_lib

    make_eval = train_lib.make_eval_step

    def counted(*args, **kwargs):
        fn = make_eval(*args, **kwargs)

        def run(*a, **kw):
            before = kpn_apply.launches
            try:
                return fn(*a, **kw)
            finally:
                counts.append(kpn_apply.launches - before)
        return run

    train_lib.make_eval_step = counted
    try:
        yield counts
    finally:
        train_lib.make_eval_step = make_eval


def _recipe_run(out: Path, teacher: bool) -> dict:
    """kpn-hq through tools/pretrain_flagship.py, from the release weights:
    its summary, launches (steps and validation apart), wall and peak."""
    import shutil

    from deepdenoiser_tpu_torch.tools import pretrain_flagship

    for d in (out, Path(f"{out}-best")):
        shutil.rmtree(d, ignore_errors=True)
    argv = ["--model", "kpn-hq", "--init-from", str(ROOT / "weights" / "kpn_hq_ema_f16.npz"),
            "--family", "mixed", "--batch", str(TRAIN_BATCH), "--crop", str(TRAIN_CROP),
            "--steps", str(RELEASE_STEPS), "--val-every", str(RELEASE_VAL_EVERY),
            "--log-every", str(RELEASE_LOG_EVERY), "--out", str(out)]
    if teacher:
        argv += ["--teacher", RELEASE_TEACHER]
    args = pretrain_flagship.build_parser().parse_args(argv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with _k1_in_validation([]) as in_val, contextlib.redirect_stdout(io.StringIO()):
        summary = pretrain_flagship.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_val = len(summary["val"]) * pretrain_flagship.VAL_BATCHES
    if in_val != [8] * n_val or n_val != 2 * pretrain_flagship.VAL_BATCHES:
        raise AssertionError(f"recipe: K1 launches in validation {in_val}, want 8 in each of "
                             f"{2 * pretrain_flagship.VAL_BATCHES} batches")
    # validation's launches taken out: K1's as counted, the softmax's one a slot (8 a batch)
    # and the conv epilogues' (the student's 21 a batch)
    steps = {**launches, "kpn_apply": launches["kpn_apply"] - sum(in_val),
             "kpn_softmax": launches["kpn_softmax"] - 8 * n_val,
             "bias_act": launches["bias_act"] - EPILOGUES["kpn-hq"] * n_val}
    # a step: the student's forward, and the teacher's where there is one
    expect_launches(f"recipe steps (teacher {teacher})", steps, RELEASE_STEPS, kpn_apply=8,
                    kpn_apply_bwd_weights=8, kpn_softmax=8,
                    bias_act=EPILOGUES["kpn-hq"] + (EPILOGUES[RELEASE_TEACHER] if teacher else 0))
    losses = [r["loss"] for r in summary["log"]]
    if [r["step"] for r in summary["log"]] != list(range(RELEASE_LOG_EVERY, RELEASE_STEPS + 1,
                                                          RELEASE_LOG_EVERY)) \
            or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"recipe: log {summary['log']}")
    seg = [r["ms_per_step"] for r in summary["log"][1:]]  # the first segment warms up
    return {"summary": summary, "wall_s": wall,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "ms": statistics.median(seg), "ms_segments": [r["ms_per_step"] for r in summary["log"]],
            "launches_per_step": {k: v / RELEASE_STEPS for k, v in steps.items()},
            "launches_per_val_batch": in_val[0]}


def phase_release(frame: dict, card: dict) -> dict:
    """The release tooling on the card at full width: (a) the four frozen TF
    goldens through compat/goldens.check (2 K1 launches for kpn), then the
    four goldens made by the port on the card (goldens.make) and read back
    by goldens.check (2 K1 launches each for kpn), on the card and on the
    CPU, their checkpoints byte-equal to a CPU make's; (b)
    kpn-hq's release weights through the port's TF writer and reader,
    bitwise, and the 1080p frame with them bitwise equal to the release
    weights' frame; (c) tools/pretrain_flagship.py: kpn-hq from the release
    npz, teacher flagship-hq, mixed family, batch 16, crop 96, 20 steps,
    validation every 10 (8 K1 and 8 d_w launches a step, 8 K1 a validation
    batch, a -best checkpoint with its extra), and the same run without a
    teacher; (d) the -best checkpoint through
    tools/export_release_weights.py and `deepdenoiser-torch denoise
    --weights` on the 1080p frame."""
    import numpy as np

    from deepdenoiser_tpu_torch import config, weights_io
    from deepdenoiser_tpu_torch.compat import goldens
    from deepdenoiser_tpu_torch.compat import tf_checkpoint as tfc
    from deepdenoiser_tpu_torch.inference import pipeline
    from deepdenoiser_tpu_torch.tools import export_release_weights
    from deepdenoiser_tpu_torch.training.checkpoint import CheckpointManager

    work = WORK / "release"
    work.mkdir(parents=True, exist_ok=True)
    res = {"goldens": {}}

    # (a) the goldens, each forwarded on the card in fp32
    for fam in sorted(goldens.GOLDEN_CFGS):
        reset_launches()
        dev = goldens.check(fam, device="cuda")
        torch.cuda.synchronize()
        launches = read_launches()
        expect_launches(f"golden {fam}", launches, kpn_apply=2 if fam == "kpn" else 0,
                        kpn_softmax=2 if fam == "kpn" else 0, bias_act=EPILOGUES[f"golden {fam}"])
        res["goldens"][fam] = {"max_abs_dev": dev, "kpn_apply": launches["kpn_apply"],
                               "kpn_softmax": launches["kpn_softmax"]}
    log("[release] TF goldens on the card (fp32, TF32 off), max|d| against io.npz y, limit "
        f"{goldens.ATOL:g}: " + ", ".join(f"{f} {r['max_abs_dev']:.3e} ({r['kpn_apply']} K1)"
                                          for f, r in res["goldens"].items()))

    # (a') the goldens made by the port on the card (goldens.make: init from
    # seed 7, the port's TF writer, the fp32 forward), read back by its check
    made = work / "made"
    res["made"] = {}
    for fam in sorted(goldens.GOLDEN_CFGS):
        reset_launches()
        t0 = time.perf_counter()
        goldens.make(fam, made / fam, device="cuda")
        torch.cuda.synchronize()
        make_s = time.perf_counter() - t0
        make_launches = read_launches()
        reset_launches()
        t0 = time.perf_counter()
        dev = goldens.check(fam, indir=made, device="cuda")
        torch.cuda.synchronize()
        check_s = time.perf_counter() - t0
        check_launches = read_launches()
        for what, launches in (("make", make_launches), ("check", check_launches)):
            expect_launches(f"made golden {fam}, {what}", launches,
                            kpn_apply=2 if fam == "kpn" else 0,
                            kpn_softmax=2 if fam == "kpn" else 0,
                            bias_act=EPILOGUES[f"golden {fam}"])
        # held independently of the card: the card-made y against the CPU's
        # forward of the same checkpoint (the plain filter apply, no cuDNN),
        # and the checkpoint's bytes against a CPU make's
        cpu_dev = goldens.check(fam, indir=made, device="cpu")
        goldens.make(fam, work / "made_cpu" / fam, device="cpu")
        for name in ("model.ckpt.index", "model.ckpt.data-00000-of-00001"):
            if (made / fam / name).read_bytes() != (work / "made_cpu" / fam / name).read_bytes():
                raise AssertionError(f"made golden {fam}: {name} made on the card != the CPU's")
        res["made"][fam] = {"max_abs_dev": dev, "max_abs_dev_cpu": cpu_dev, "make_s": make_s,
                            "check_s": check_s,
                            "kpn_apply": make_launches["kpn_apply"] + check_launches["kpn_apply"]}
    log("[release] TF goldens made by the port on the card (goldens.make, fp32, TF32 off), "
        f"max|d| of the made y, limit {goldens.ATOL:g}, against goldens.check on the card / on "
        "the CPU (plain K1, no cuDNN; checkpoint bytes == a CPU make's): "
        + ", ".join(f"{f} {r['max_abs_dev']:.3e} / {r['max_abs_dev_cpu']:.3e} (make "
                    f"{r['make_s']:.3f} s, check {r['check_s']:.3f} s, {r['kpn_apply']} K1)"
                    for f, r in res["made"].items())
        + f" | {card['smi']}")

    # (b) kpn-hq's release weights through a TF checkpoint and back
    cfg = config.validate_channels(config.PRESETS["kpn-hq"])
    params = weights_io.load_release_params(ROOT / "weights" / "kpn_hq_ema_f16.npz")
    prefix = work / "tf" / "model.ckpt"
    prefix.parent.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    names = tfc.export_checkpoint(params, cfg.model, prefix)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = tfc.import_checkpoint(prefix, cfg.model)
    read_s = time.perf_counter() - t0
    nbytes = sum(p.stat().st_size for p in prefix.parent.glob("model.ckpt.*"))
    want, got = weights_io.flatten(params), weights_io.flatten(back)
    if sorted(got) != sorted(want) or any(got[k].tobytes() != v.tobytes() for k, v in want.items()):
        raise AssertionError("kpn-hq release weights changed through the TF checkpoint")
    noisy = {k: torch.as_tensor(v, device="cuda") for k, v in frame["noisy"].items()}
    clean_c, noisy_c = _frame_on_card(frame)
    outs, launches = [], None
    with deterministic_convs():
        for tree in (params, back):
            den, _ = pipeline.make_joint_frame_denoiser(cfg.model, cfg.infer, FRAME_H, FRAME_W,
                                                        tree)
            den(noisy)  # warm-up
            torch.cuda.synchronize()
            reset_launches()
            outs.append(den(noisy))
            torch.cuda.synchronize()
            launches = read_launches()
            expect_launches("kpn-hq frame, release / round-tripped weights", launches,
                            kpn_apply=8, kpn_softmax=8, bias_act=EPILOGUES["kpn-hq"])
            del den
    check_frame("kpn-hq with round-tripped weights", outs[1])
    if set(outs[0]) != set(outs[1]) or not all(torch.equal(outs[0][k], outs[1][k])
                                               for k in outs[0]):
        raise AssertionError("kpn-hq frame with round-tripped weights != release weights' frame")
    res["tf"] = {"variables": len(names), "bytes": nbytes, "write_s": write_s, "read_s": read_s,
                 "kpn_apply": launches["kpn_apply"],
                 "gain_db": _gain_db(outs[1]["combined"], noisy_c, clean_c)}
    del outs
    torch.cuda.empty_cache()
    log(f"[release] kpn-hq release npz -> TF checkpoint ({len(names)} variables, {nbytes} bytes "
        f"in .index + .data) in {write_s:.3f} s -> read back in {read_s:.3f} s: bitwise equal; "
        f"the 1080p frame with the round-tripped weights == the release weights' frame, bitwise, "
        f"{launches['kpn_apply']} K1 launches, gain {res['tf']['gain_db']:.4f} dB")

    # (c) the recipe, with and without the teacher
    out = work / "kpn-hq"
    taught = _recipe_run(out, teacher=True)
    state, extra = CheckpointManager(f"{out}-best").read_latest(map_location="cpu")
    if set(extra) != RELEASE_EXTRA or extra["model"] != "kpn-hq" or extra["mode"] != "joint":
        raise AssertionError(f"recipe: -best extra {extra}")
    plain = _recipe_run(work / "kpn-hq-plain", teacher=False)
    res["recipe"] = {"teacher": taught, "plain": plain, "best_step": state["step"],
                     "best_extra": extra}
    del state
    for label, r in (("teacher " + RELEASE_TEACHER, taught), ("no teacher", plain)):
        s = r["summary"]
        log(f"[release] recipe kpn-hq, {label}: batch {TRAIN_BATCH}, crop {TRAIN_CROP}, mixed, "
            f"{RELEASE_STEPS} steps from the release npz: {r['ms']:.2f} ms/step (median of the "
            f"{RELEASE_LOG_EVERY}-step segments after the first; host clock, validation and "
            f"saves out; segments " + " ".join(f"{v:.2f}" for v in r["ms_segments"])
            + f"), wall {r['wall_s']:.1f} s, peak {r['peak_gib']:.2f} GiB; loss "
            + " ".join(f"{x['loss']:.4f}" for x in s["log"]) + "; val psnr_encoded "
            + " ".join(f"{v['step']}:{v['psnr_encoded']:.3f}" for v in s["val"])
            + f" dB; launches a step {r['launches_per_step']['kpn_apply']:g} K1, "
            f"{r['launches_per_step']['kpn_apply_bwd_weights']:g} d_w; "
            f"{r['launches_per_val_batch']} K1 a validation batch | {card['smi']}")
    log(f"[release] -best checkpoint at step {res['recipe']['best_step']}, extra {extra}")

    # (d) the -best checkpoint exported and denoising through the CLI
    npz = work / "kpn_hq_best_f16.npz"
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = export_release_weights.main(["--ckpt", f"{out}-best", "--out", str(npz),
                                          "--model", "kpn-hq"])
    if rc != 0:
        raise AssertionError(f"export_release_weights returned {rc}")
    shipped = ROOT / "weights" / "kpn_hq_ema_f16.npz"
    with np.load(npz) as a, np.load(shipped) as b:
        layout = {k: (a[k].shape, a[k].dtype) for k in a.files}
        if layout != {k: (b[k].shape, b[k].dtype) for k in b.files}:
            raise AssertionError("exported npz: keys/shapes/dtypes differ from the release file's")
    cli_out, cli_launches = _cli_denoise("kpn-hq-export", frame, ["--preset", "kpn-hq"], str(npz),
                                         "joint")
    expect_launches("kpn-hq cli frame with the exported npz", cli_launches, kpn_apply=8,
                    kpn_softmax=8, bias_act=EPILOGUES["kpn-hq"])
    res["export"] = {"bytes": npz.stat().st_size, "shipped_bytes": shipped.stat().st_size,
                     "arrays": len(layout), "kpn_apply": cli_launches["kpn_apply"],
                     "gain_db": _gain_db(cli_out, noisy_c, clean_c),
                     "printed": printed.getvalue().strip().replace("\n", "; ")}
    if not res["export"]["gain_db"] > 0:
        raise AssertionError(f"exported npz: no gain ({res['export']['gain_db']})")
    log(f"[release] export: {res['export']['printed']} | {res['export']['bytes']} bytes "
        f"(shipped {res['export']['shipped_bytes']}), {len(layout)} arrays with the release "
        f"file's keys, shapes and fp16; `denoise --weights` on the 1080p frame: gain "
        f"{res['export']['gain_db']:.4f} dB, {cli_launches['kpn_apply']} K1 launches")
    torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------------------
# the measurement and evaluation tools
# --------------------------------------------------------------------------

TOOLS_EVAL_H, TOOLS_EVAL_W = 540, 960  # eval_holdout, eval_zoo: see phase_tools
TOOLS_PIPE_STEPS = 30
MULTILAYER_EXR = WORK / "multilayer" / "frame.exr"


def _write_multilayer(path: Path, h: int, w: int) -> float:
    """The 1080p noisy frame (_fourier_frame's) as one multilayer EXR at
    `path`; numpy on the host, run in the worker process beside the card.
    Returns the seconds it took."""
    from deepdenoiser_tpu_torch.data import exr, synthetic

    t0 = time.perf_counter()
    clean = synthetic.generate_clean_passes(h, w, seed=0)
    exr.save_multilayer_exr(path, synthetic.add_mc_noise(clean, spp=4, seed=1))
    return time.perf_counter() - t0


def _pipe_corpus(crop: int) -> tuple:
    """tools/bench_input_pipeline.py's corpus at `crop` under WORK (EXR
    renders and shards: numpy on the host, about a minute), built in the
    worker process beside the card. Returns (shard dir, seconds)."""
    from deepdenoiser_tpu_torch.tools import bench_input_pipeline

    t0 = time.perf_counter()
    shards = bench_input_pipeline._build_corpus(WORK / "pipe_bench", crop)
    return shards, time.perf_counter() - t0


@contextlib.contextmanager
def counting_frames():
    """Yields a list that gets one [frames, K1 launches] record per joint
    or group frame denoiser called inside the block, in the order they are
    first called: each call of a denoiser adds one frame and the K1
    launches made during it."""
    from deepdenoiser_tpu_torch.inference import pipeline
    from deepdenoiser_tpu_torch.ops import kpn_apply

    records = []
    originals = {cls: cls.__call__ for cls in (pipeline.JointFrameDenoiser,
                                               pipeline.GroupFrameDenoiser)}

    def counted(call):
        def run(self, pass_dict):
            if "_smoke_frames" not in self.__dict__:
                self._smoke_frames = [0, 0]
                records.append(self._smoke_frames)
            before = kpn_apply.launches
            out = call(self, pass_dict)
            self._smoke_frames[0] += 1
            self._smoke_frames[1] += kpn_apply.launches - before
            return out
        return run

    for cls, call in originals.items():
        cls.__call__ = counted(call)
    try:
        yield records
    finally:
        for cls, call in originals.items():
            cls.__call__ = call


def _run_counted(what: str, call) -> dict:
    """call() in-process on the card, stdout captured, every launch count
    set to 0 just before and read just after. Returns {json: the dict call()
    returned, else the last JSON line it printed, denoisers: [frames, K1] per
    frame denoiser, launches, s, out}."""
    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with counting_frames() as records, contextlib.redirect_stdout(buf):
        got = call()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    if not isinstance(got, dict) and got != 0:
        raise AssertionError(f"{what} returned {got}: {buf.getvalue()}")
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{") and ln.endswith("}")]
    torch.cuda.empty_cache()
    return {"json": got if isinstance(got, dict) else json.loads(lines[-1]) if lines else None,
            "denoisers": records, "launches": launches, "s": secs, "out": buf.getvalue()}


def _run_tool(name: str, argv: list) -> dict:
    """tools/<name>.main(argv) through _run_counted, on the card (its
    default device)."""
    import importlib

    module = importlib.import_module(f"deepdenoiser_tpu_torch.tools.{name}")
    return _run_counted(f"tools/{name} {' '.join(argv)}", lambda: module.main(argv))


def _per_frame(what: str, run: dict, k1_per_frame: list, epilogues_per_frame: list,
               **other_per_frame) -> int:
    """Check each frame denoiser's K1 launches a frame (one entry per
    denoiser, in order), the conv epilogues of all its frames (one entry per
    denoiser: launches a frame) and that no other kernel launched but as
    given per frame; returns the frames denoised."""
    got = [(n, k) for n, k in run["denoisers"]]
    if len(got) != len(k1_per_frame) or any(
            n < 1 or k != want * n for (n, k), want in zip(got, k1_per_frame)):
        raise AssertionError(f"{what}: (frames, K1 launches) per denoiser {got}, want "
                             f"{k1_per_frame} K1 a frame")
    frames = sum(n for n, _ in got)
    want = {name: 0 for name in run["launches"]}
    # the tools run the head as it is: its softmax launches once before each K1 launch
    want["kpn_apply"] = want["kpn_softmax"] = sum(k for _, k in got)
    want["bias_act"] = sum(n * e for (n, _), e in zip(got, epilogues_per_frame))
    for name, per in other_per_frame.items():
        want[name] = per * frames
    if run["launches"] != want:
        raise AssertionError(f"{what}: kernel launches {run['launches']}, want {want}")
    return frames


def _gains_positive(what: str, row: dict) -> None:
    bad = {k: v for k, v in row.items() if "gain" in k and not v > 0}
    if bad:
        raise AssertionError(f"{what}: no PSNR gain: {bad} in {row}")


def phase_tools(frame: dict, card: dict, kpn_res: dict, multilayer, corpus) -> dict:
    """The port's tools (deepdenoiser_tpu_torch/tools/), each main(argv)
    in-process on the card, its last JSON line checked, the K1 launches of
    each frame denoiser counted: bench_model (kpn-hq 8 a frame, kpn 2),
    bench_4k (tile 512 / tile_batch 8: 40 a frame; sweep_4k's whole-frame
    and 1088/2 configs: 8 and 32), bench_sequence (8), bench_input_pipeline
    (8 K1 and 8 d_w a step), eval_holdout and eval_zoo at 540x960 (the
    numpy spheres and boxes families and the 1024-spp traced GT at 1080p
    would not fit the phase's time), profile, the first config of each
    1080p sweep, diag_multiscale on seeded weights (the repo ships none),
    split_multilayer on the 1080p frame's multilayer EXR. The worker
    process wrote that EXR (`multilayer`) and the input pipeline's corpus
    (`corpus`, with the tool's own _build_corpus) beside the earlier
    phases."""
    import numpy as np

    from deepdenoiser_tpu_torch.data import exr
    from deepdenoiser_tpu_torch.tools import eval_zoo, sweep_4k, sweep_bench, sweep_joint
    from deepdenoiser_tpu_torch.tools.pretrain_flagship import MODELS

    res = {"s": {}, "k1_per_frame": {}}

    def tool(label, name, argv):
        run = _run_tool(name, argv)
        res["s"][label] = run["s"]
        return run

    def measured(label, run, index=0):  # K1 launches a frame of one denoiser, as counted
        frames, k1 = run["denoisers"][index]
        res["k1_per_frame"][label] = k1 / frames

    # bench_model: the per-model 1080p latency
    res["bench_model"] = {}
    for model, k1 in (("kpn-hq", 8), ("kpn", 2)):
        run = tool(f"bench_model {model}", "bench_model", ["--model", model])
        _per_frame(f"bench_model {model}", run, [k1], [EPILOGUES[model]])
        measured(f"tools/bench_model {model} frame", run)
        _gains_positive(f"bench_model {model}", run["json"])
        res["bench_model"][model] = run["json"]
    bm = res["bench_model"]["kpn-hq"]
    log(f"[tools] bench_model kpn-hq: {bm['latency_ms']:.2f} ms/frame (median of 5 samples "
        f"of 8 frames, CUDA events; samples {bm['samples_ms']}) beside phase 4's "
        f"{kpn_res['ms_median']:.2f} (host clock around each frame's synchronize); gain "
        f"{bm['gain_db']} dB, SSIM {bm['ssim']}; kpn (group) {res['bench_model']['kpn']['latency_ms']:.2f}"
        f" ms/frame, gain {res['bench_model']['kpn']['gain_db']} dB | {card['smi']}")

    # bench_4k: tiled, and two of sweep_4k's configs
    res["bench_4k"] = {}
    for cfg, k1 in ((["--tile", "512", "--tile-batch", "8"], 40), (sweep_4k.CONFIGS[0], 8),
                    (sweep_4k.CONFIGS[2], 32)):
        label = " ".join(cfg)
        run = tool(f"bench_4k {label}", "bench_4k", ["--model", "kpn-hq", "--frames", "2", *cfg])
        # one network call a chunk of tiles, as one a K1 slot x 8
        _per_frame(f"bench_4k {label}", run, [k1], [EPILOGUES["kpn-hq"] * k1 // 8])
        measured(f"tools/bench_4k kpn-hq frame, {label}", run)
        j = run["json"]
        if not j["psnr_mean"] > j["psnr_noisy_mean"] or len(j["latency_ms"]) != 2:
            raise AssertionError(f"bench_4k {label}: {j}")
        res["bench_4k"][label] = j
        log(f"[tools] bench_4k kpn-hq {j['resolution']} {label}: {j['latency_ms']} ms/frame (4 denoises "
            f"between CUDA events a frame), PSNR {j['psnr_mean']} dB (noisy "
            f"{j['psnr_noisy_mean']}), SSIM {j['ssim_mean']}; {k1} K1 a frame | {card['smi']}")

    # bench_sequence: 4 coherent 4K frames
    run = tool("bench_sequence", "bench_sequence",
               ["--model", "kpn-hq", "--weights", str(ROOT / "weights" / "kpn_hq_ema_f16.npz"),
                "--frames", "4"])
    _per_frame("bench_sequence", run, [8], [EPILOGUES["kpn-hq"]])
    measured("tools/bench_sequence kpn-hq 4K frame", run)
    seq = res["bench_sequence"] = run["json"]
    if not seq["gain_db_mean"] > 0 or len(seq["frames"]) != 4:
        raise AssertionError(f"bench_sequence: {seq}")
    log(f"[tools] bench_sequence kpn-hq, 4 frames of {seq['resolution']}: {seq['per_frame_ms_chained']} "
        f"ms/frame chained ({seq['fps']} fps; generation {seq['gen_chain_ms_total']} ms for all "
        f"4, taken out), series {[f['latency_ms'] for f in seq['frames']]} ms, gain "
        f"{seq['gain_db_mean']} dB, SSIM {seq['ssim_mean']} | {card['smi']}")

    # bench_input_pipeline: the loader, the fit path, device batches
    shards, res["corpus_s"] = corpus.result()
    run = tool("bench_input_pipeline", "bench_input_pipeline",
               ["--model", "kpn-hq", "--batch", str(TRAIN_BATCH), "--crop", str(TRAIN_CROP),
                "--steps", str(TOOLS_PIPE_STEPS), "--shards", str(shards)])
    steps = 2 * (TOOLS_PIPE_STEPS + 1)  # two timed paths, each after a warm-up step
    expect_launches("bench_input_pipeline", run["launches"], steps, kpn_apply=8,
                    kpn_apply_bwd_weights=8, kpn_softmax=8, bias_act=EPILOGUES["kpn-hq"])
    pipe = res["bench_input_pipeline"] = dict(
        run["json"], steps=steps, launches_per_step={k: v / steps for k, v in run["launches"].items()})
    rates = ("host_iter_batches_per_s", "grain_2dispatch_steps_per_s", "synth_fused_steps_per_s",
             "grain_vs_synth")
    if not all(math.isfinite(pipe[k]) and pipe[k] > 0 for k in rates):
        raise AssertionError(f"bench_input_pipeline: {pipe}")
    log(f"[tools] bench_input_pipeline kpn-hq batch {TRAIN_BATCH} crop {TRAIN_CROP}, "
        f"{TOOLS_PIPE_STEPS} steps: loader {pipe['host_iter_batches_per_s']} batches/s, fit path "
        f"{pipe['grain_2dispatch_steps_per_s']} steps/s, device batches "
        f"{pipe['synth_fused_steps_per_s']} steps/s (ratio {pipe['grain_vs_synth']}); 8 K1 + 8 "
        f"d_w a step over {steps} steps; corpus built by the worker in {res['corpus_s']:.1f} s "
        f"| {card['smi']}")

    # eval_holdout and eval_zoo
    size = ["--height", str(TOOLS_EVAL_H), "--width", str(TOOLS_EVAL_W), "--frames", "1"]
    run = tool("eval_holdout", "eval_holdout", [*size, "--spp", "4"])
    _per_frame("eval_holdout", run, [0] * 4, [EPILOGUES["flagship"]] * 4)
    res["eval_holdout"] = run["json"]["eval_holdout"]
    for row in res["eval_holdout"]:
        _gains_positive(f"eval_holdout {row['family']}", row)
    log(f"[tools] eval_holdout flagship {TOOLS_EVAL_H}x{TOOLS_EVAL_W} spp 4: " + ", ".join(
        f"{r['family']} {r['gain_db']:+.2f} dB (SSIM {r['ssim']}, {r['latency_ms']} ms)"
        for r in res["eval_holdout"]) + f" | {card['smi']}")
    zoo_models = (("kpn-hq", 8), ("flagship-hq", 0), ("kpn", 2))
    run = tool("eval_zoo", "eval_zoo", ["--models", *(m for m, _ in zoo_models), *size])
    _per_frame("eval_zoo", run, [k for _, k in zoo_models], [EPILOGUES[m] for m, _ in zoo_models])
    for i, (model, _) in enumerate(zoo_models):
        measured(f"tools/eval_zoo {model} frame", run, i)
    res["eval_zoo"] = run["json"]["zoo"]
    if [r["model"] for r in res["eval_zoo"]] != [m for m, _ in zoo_models]:
        raise AssertionError(f"eval_zoo: {res['eval_zoo']}")
    for row in res["eval_zoo"]:
        _gains_positive(f"eval_zoo {row['model']}", row)
        if row["latency_ms"] is None or "mc_gain_db" not in row:
            raise AssertionError(f"eval_zoo {row['model']}: {row}")
        log(f"[tools] eval_zoo {row['model']} {TOOLS_EVAL_H}x{TOOLS_EVAL_W}: {row['latency_ms']} ms/frame; gain "
            + ", ".join(f"{f} {row[f + '_gain_db']:+.2f}"
                        for f in ("train", "voronoi", "holdout", "holdout2", "mc"))
            + f" dB | {card['smi']}")

    # profile: a Chrome trace of two flagship frames
    trace_dir = WORK / "trace"
    run = tool("profile", "profile", ["--iters", "2", "--out", str(trace_dir)])
    _per_frame("profile", run, [0], [EPILOGUES["flagship"]])
    names = {e.get("name") for e in json.loads((trace_dir / "trace.json").read_text())["traceEvents"]}
    if not {"frame_0", "frame_1"} <= names:
        raise AssertionError("profile: the trace lacks frame_0 / frame_1")
    res["profile"] = {"events": len(names), "bytes": (trace_dir / "trace.json").stat().st_size}

    # the sweeps' measure() on their first config, on the 1080p frame
    noisy = eval_zoo.to_device(frame["noisy"], torch.device("cuda"))
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res["sweep_bench"] = sweep_bench.measure(*sweep_bench.CONFIGS[0], noisy)
        res["sweep_joint"] = sweep_joint.measure(sweep_joint.CONFIGS[0], noisy)
    res["s"]["sweeps"] = time.perf_counter() - t0
    # each measure(): 2 warm-up frames and K x SAMPLES timed, one network call a frame
    expect_launches("sweeps", read_launches(), 2 * (2 + sweep_bench.K * sweep_bench.SAMPLES),
                    bias_act=EPILOGUES["sweep s2d depth-3"])
    log(f"[tools] sweep_bench first config (group, s2d, base 48) {res['sweep_bench']:.2f} "
        f"ms/frame; sweep_joint first config (joint, s2d, base 64) {res['sweep_joint']:.2f} "
        f"ms/frame (random weights) | {card['smi']}")
    del noisy

    # diag_multiscale on seeded weights
    load = eval_zoo.load_model_params
    params = _seeded_params(MODELS["multiscale"])
    eval_zoo.load_model_params = lambda name: (MODELS[name], params, "joint")
    try:
        run = tool("diag_multiscale", "diag_multiscale", ["--frames", "1"])
    finally:
        eval_zoo.load_model_params = load
    # its base UNet (21 convs) at 3, 2 and 1 scales
    _per_frame("diag_multiscale", run, [0] * 3,
               [EPILOGUES["unet-multiscale"] // 3 * n for n in (3, 2, 1)])
    res["diag_multiscale"] = run["json"]["multiscale_diag"]
    if [r["n_scales"] for r in res["diag_multiscale"]] != [3, 2, 1] or not all(
            math.isfinite(v) for r in res["diag_multiscale"] for v in r.values()):
        raise AssertionError(f"diag_multiscale: {res['diag_multiscale']}")

    # split_multilayer on the 1080p frame's multilayer EXR
    res["multilayer_write_s"] = multilayer.result()
    run = tool("split_multilayer", "split_multilayer", [str(MULTILAYER_EXR)])
    split = exr.load_frame_dir(MULTILAYER_EXR.parent, strict=False)
    if set(split) != set(frame["noisy"]) or not all(
            np.array_equal(split[k], np.asarray(v, np.float32)) for k, v in frame["noisy"].items()):
        raise AssertionError("split_multilayer: the split passes differ from the frame's")
    log(f"[tools] profile: trace {res['profile']['bytes']} bytes with frame_0, frame_1; "
        f"diag_multiscale 512x768 (seeded weights): {res['diag_multiscale']}; split_multilayer: "
        f"{len(split)} passes of the 1080p frame read back equal (multilayer written in "
        f"{res['multilayer_write_s']:.1f} s by the worker) | {card['smi']}")
    log("[tools] seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in res["s"].items()))
    return res


# --------------------------------------------------------------------------
# the headline benchmark, the roofline, the EXR codec's native path
# --------------------------------------------------------------------------

BENCH_MS_TOL = 0.03  # the bench's CUDA-event ms against phases 4 and 5's host-clock medians
BENCH_FAMILIES = ("fourier", "holdout", "holdout2", "mc")
BENCH_ENDPOINT_KEYS = {"model", "ms", "fps", "weights",
                       *(f"{m}_{f}" for f in BENCH_FAMILIES for m in ("db", "ssim"))}
# the speed endpoint's traced-MC column: the Gaussian-trained s2d flagship
# loses on real Monte-Carlo noise (the JAX package's record: -0.32 dB,
# docs/STATUS_R5.md:32), so that one gain is required finite, not > 0
BENCH_GAIN_EXEMPT = {("flagship", "db_mc")}
ROOFLINE_MODELS = ("kpn-hq", "flagship-hq", "flagship")
EXR_TURNS = ("numpy", "native", "native", "numpy")


def _check_bench(what: str, rec: dict, models: tuple) -> None:
    """bench's JSON contract on the card: the top keys, status ok, value =
    the headline fps, vs_baseline = fps / 10, the three endpoints with every
    key and every gain > 0 (BENCH_GAIN_EXEMPT: finite)."""
    top = {"metric", "value", "unit", "vs_baseline", "status", "headline", "speed", "mc"}
    head = rec["headline"]
    if (not top <= set(rec) or rec["metric"] != "1080p_full_multipass_denoise_throughput"
            or rec["unit"] != "frames/sec/chip" or rec["status"] != "ok"
            or rec["value"] != head["fps"] or rec["vs_baseline"] != round(head["fps"] / 10, 3)):
        raise AssertionError(f"{what}: the record breaks the contract: {rec}")
    for key, model in zip(("headline", "speed", "mc"), models):
        obj = rec[key]
        if set(obj) != BENCH_ENDPOINT_KEYS or obj["model"] != model or obj["weights"] != "release":
            raise AssertionError(f"{what}: {key} {obj}")
        if not (obj["ms"] > 0 and obj["fps"] > 0):
            raise AssertionError(f"{what}: {key} latency {obj}")
        bad = {k: v for k, v in obj.items() if k.startswith("db_") and not (
            math.isfinite(v) if (model, k) in BENCH_GAIN_EXEMPT else v > 0)}
        if bad:
            raise AssertionError(f"{what}: {key} {model} has no gain: {bad}")


def phase_bench(frame: dict, card: dict, kpn_res: dict, hq_res: dict, holdouts,
                mc_res: dict) -> dict:
    """tools/bench.main in-process on the card with its defaults (flagship-hq,
    flagship, flagship-mc) and with --model kpn-hq (8 K1 launches a frame),
    on the frames the earlier phases made: the Fourier frame, the worker's
    two 1080p holdouts and phase 19's traced frame (measure takes them
    ready, as the JAX script's does). The headline ms within 3 % of phases
    5 and 4's medians in this call."""
    dev = torch.device("cuda")
    hold = _load_holdouts(holdouts.result())
    frames = {}
    for fam, (noisy, clean) in (("fourier", (frame["noisy"], frame["clean"]["combined"])),
                                ("holdout", hold["spheres"][:2]), ("holdout2", hold["boxes"][:2])):
        frames[fam] = ({k: torch.as_tensor(v, device=dev) for k, v in noisy.items()},
                       torch.as_tensor(clean, device=dev))
    noisy, clean = mc_res["frame"]
    frames["mc"] = ({k: v.to(dev) for k, v in noisy.items()}, clean.to(dev))
    from deepdenoiser_tpu_torch.tools import bench

    res = {}
    for label, argv, models, k1, ref in (
            ("defaults", [], ("flagship-hq", "flagship", "flagship-mc"), [0, 0, 0], hq_res),
            ("kpn-hq", ["--model", "kpn-hq"], ("kpn-hq", "flagship", "flagship-mc"), [8, 0, 0],
             kpn_res)):
        run = _run_counted(f"tools/bench {' '.join(argv)}",
                           lambda: bench.run(bench.parse_args(argv), frames))
        _per_frame(f"bench {label}", run, k1, [EPILOGUES[m] for m in models])
        frames_denoised, k1_launches = run["denoisers"][0]  # the headline denoiser, as counted
        rec = run["json"]
        _check_bench(f"bench {label}", rec, models)
        head = rec["headline"]
        rel = head["ms"] / ref["ms_median"] - 1
        if abs(rel) > BENCH_MS_TOL:
            raise AssertionError(f"bench {label}: {head['model']} {head['ms']} ms against the "
                                 f"phase's {ref['ms_median']:.2f} ({100 * rel:+.1f} %)")
        res[label] = dict(rec, s=run["s"], k1_per_frame=k1_launches / frames_denoised,
                          vs_phase=rel)
        log(f"[bench] {label}: value {rec['value']} fps (vs_baseline {rec['vs_baseline']}); "
            + "; ".join(f"{key} {rec[key]['model']} {rec[key]['ms']} ms " + ", ".join(
                f"{f} {rec[key]['db_' + f]:+.2f} dB" for f in BENCH_FAMILIES)
                for key in ("headline", "speed", "mc"))
            + f"; headline {100 * rel:+.2f} % against the phase's host-clock median "
            f"{ref['ms_median']:.2f} ms; K1 a headline frame {res[label]['k1_per_frame']} (counted: "
            f"{k1_launches} in {frames_denoised} frames; {run['s']:.1f} s) | {card['smi']}")
    return res


def phase_roofline(card: dict) -> dict:
    """tools/roofline for kpn-hq, flagship-hq and flagship at 1080p with a
    32 px border (0 < mfu <= 1, 0 < hbm_utilization <= 1.05), and
    tools/traffic_breakdown --time for kpn-hq (its op table's kpn_apply row
    holds the frame's 8 launches)."""
    res = {}
    for model in ROOFLINE_MODELS:
        run = _run_tool("roofline", ["--model", model, "--border", "32"])
        _per_frame(f"roofline {model}", run, [8 if model == "kpn-hq" else 0], [EPILOGUES[model]])
        frames, k1 = run["denoisers"][0]
        rep = json.loads(run["out"][run["out"].index("{"):])
        if not (0 < rep["mfu"] <= 1 and 0 < rep["hbm_utilization"] <= 1.05):
            raise AssertionError(f"roofline {model}: {rep}")
        if rep["device"] != card["kind"] or rep["weights"] != "release":
            raise AssertionError(f"roofline {model}: {rep}")
        res[model] = dict(rep, k1_per_frame=k1 / frames)
        log(f"[roofline] {model} 1080p, border 32: {rep['latency_ms']} ms, "
            f"{rep['gflops_per_frame']} GFLOP and {rep['hbm_gb_per_frame']} GB a frame (counted "
            f"from the shapes); mfu {rep['mfu']}, hbm_utilization {rep['hbm_utilization']}, "
            f"speed of light {rep['speed_of_light_ms']} ms (compute {rep['sol_compute_ms']}, "
            f"HBM {rep['sol_hbm_ms']}), {rep['bound']}-bound | {rep['device']}, power limit "
            f"{rep['power_limit_w']} W; K1 {k1} in {frames} frames | {card['smi']}")
    out = WORK / "traffic_breakdown.txt"
    run = _run_tool("traffic_breakdown", ["--model", "kpn-hq", "--border", "32", "--time",
                                          "--out", str(out)])
    lines = run["out"].splitlines()
    k1_row = [m for ln in lines if (m := re.match(r"\s*kpn_apply\s.*\sx(\d+)\s*$", ln))]
    k1 = run["launches"]["kpn_apply"]
    if len(k1_row) != 1 or int(k1_row[0].group(1)) != 8 or k1 < 8 or k1 % 8:
        raise AssertionError(f"traffic_breakdown kpn-hq: K1 {k1}, op table rows {k1_row}")
    stage_ms = {m.group(1): float(m.group(2)) for ln in lines
                if (m := re.match(r"\s+(encode|net|decode\+recompose|FULL pipeline|sum of "
                                  r"stages)\s+([\d.]+) ms", ln))}
    if len(stage_ms) != 5:
        raise AssertionError(f"traffic_breakdown kpn-hq: stage timings {stage_ms}")
    # the op table's frame: K1's launches as its wrapper counted them
    res["traffic_breakdown"] = {"stage_ms": stage_ms, "report": str(out.relative_to(ROOT)),
                                "k1_op_table": int(k1_row[0].group(1))}
    for ln in lines:
        log(f"[roofline] traffic_breakdown | {ln}")
    log(f"[roofline] traffic_breakdown kpn-hq: {k1} K1 launches ({run['s']:.1f} s) | "
        f"{card['smi']}")
    return res


def _exr_turns(path: Path) -> dict:
    """The 1080p multilayer EXR at `path` read and written back in turns
    (EXR_TURNS), the ZIP predictor in numpy (exr_codec's plain versions) or
    native (data/_native.py): each turn's host seconds, whether its passes
    and its file equal the first turn's bit for bit. Host work, run in the
    worker process."""
    from deepdenoiser_tpu_torch.data import exr, exr_codec

    routes = {"numpy": (exr_codec._zip_split_and_predict_np,
                        exr_codec._zip_unpredict_and_merge_np),
              "native": (exr_codec._zip_split_and_predict, exr_codec._zip_unpredict_and_merge)}
    out_dir = WORK / "exr_turns"
    out_dir.mkdir(parents=True, exist_ok=True)
    turns, ref, ref_file = [], None, None
    try:
        for i, route in enumerate(EXR_TURNS):
            exr_codec._zip_split_and_predict, exr_codec._zip_unpredict_and_merge = routes[route]
            t0 = time.perf_counter()
            passes = exr.load_multilayer_exr(path)
            read_s = time.perf_counter() - t0
            out = out_dir / f"{i}_{route}.exr"
            t0 = time.perf_counter()
            exr.save_multilayer_exr(out, passes)
            write_s = time.perf_counter() - t0
            data = out.read_bytes()
            if ref is None:
                ref, ref_file = passes, data
            turns.append({
                "route": route, "read_s": read_s, "write_s": write_s, "bytes": len(data),
                "passes_equal": set(passes) == set(ref) and all(
                    passes[k].dtype == ref[k].dtype and passes[k].shape == ref[k].shape
                    and passes[k].tobytes() == ref[k].tobytes() for k in ref),
                "file_equal": data == ref_file})
            out.unlink()
    finally:
        exr_codec._zip_split_and_predict, exr_codec._zip_unpredict_and_merge = routes["native"]
    return {"turns": turns, "source_bytes": path.stat().st_size, "passes": len(ref)}


def phase_exr(card: dict, turns) -> dict:
    """The worker's EXR turns (numpy, native, native, numpy): the native
    path's passes equal numpy's bit for bit, every written file equal, the
    seconds of each."""
    res = turns.result()
    bad = [t for t in res["turns"] if not (t["passes_equal"] and t["file_equal"])]
    if bad:
        raise AssertionError(f"exr: turns differ from the first (numpy) turn: {bad}")
    for i, t in enumerate(res["turns"]):
        log(f"[exr] turn {i} {t['route']}: read {t['read_s']:.3f} s, write {t['write_s']:.3f} s "
            f"({res['passes']} passes, {res['source_bytes']} bytes read, {t['bytes']} written; "
            f"host clock in the worker process) | {card['smi']}")
    for route in ("numpy", "native"):
        sel = [t for t in res["turns"] if t["route"] == route]
        res[route] = {k: statistics.mean(t[k] for t in sel) for k in ("read_s", "write_s")}
    log(f"[exr] mean read / write: numpy {res['numpy']['read_s']:.3f} / "
        f"{res['numpy']['write_s']:.3f} s, native {res['native']['read_s']:.3f} / "
        f"{res['native']['write_s']:.3f} s; passes and files bit-equal across the turns")
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


def _run_phases(phase, card: dict, holdouts, multilayer, corpus, exr_turns,
                profile: bool, parent_csrc) -> tuple:
    phase("build", phase_build)
    kern = phase("kernels", phase_kernels, card)
    soft = phase("kpn-softmax", phase_kpn_softmax, card)
    epilogue = phase("bias-act", phase_bias_act, card)
    ingest = phase("ingest-kernels", phase_ingest_kernels, card)

    from deepdenoiser_tpu_torch.data import exr

    t0 = time.perf_counter()
    clean, noisy = _fourier_frame()
    frame_dir = WORK / "fourier_1080p_spp4"
    exr.save_frame_dir(frame_dir, noisy)
    log(f"[frame] Fourier family 1080p spp4 written to {frame_dir.relative_to(ROOT)} "
        f"in {time.perf_counter() - t0:.1f} s")
    frame = {"clean": clean, "noisy": noisy, "dir": frame_dir}
    kpn_res = phase("kpn-hq", phase_preset, "kpn-hq", "kpn_hq_ema_f16.npz", frame, card,
                    kernel_launches_per_frame=8, check_fp32=True, profile=profile)
    hq_res = phase("flagship-hq", phase_preset, "flagship-hq", "flagship_hq_ema_f16.npz", frame,
                   card, kernel_launches_per_frame=0, check_fp32=False, profile=profile)
    max_res = phase("flagship-max", phase_flagship_max, frame, card, profile=profile)
    aux_counts = phase("aux-subsets", phase_aux_subsets, frame, card)
    per_pass_counts = phase("per-pass", phase_per_pass_encode, frame, card)
    phase("rgb", phase_rgb, frame, card)
    phase("flagship", phase_preset, "flagship", "flagship_ema_f16.npz", frame, card,
          kernel_launches_per_frame=0, check_fp32=True, profile=profile, timed_frames=5)
    uhd_res = phase("tiled-4k", phase_tiled_4k, frame, card, profile=profile)
    feather_res = phase("feather", phase_feather, frame, card)
    tir_res = {}
    for preset in ("tiramisu-lt1", "tiramisu-fast", "tiramisu"):
        tir_res[preset] = phase(preset, phase_preset, preset, preset.replace("-", "_") + "_ema_f16.npz", frame,
              card, kernel_launches_per_frame=0, check_fp32=True,
              profile=profile and preset == "tiramisu-lt1", timed_frames=5,
              gain_tol=TIRAMISU_GAIN_TOL_DB)
    phase("multiscale", phase_multiscale, frame, card)
    phase("flags", phase_flags, frame, card)
    phase("sequence", phase_sequence, frame, card)
    train_kern = phase("train-kernels", phase_train_kernels, card, parent_csrc)
    phase("train-parity", phase_train_parity, card)
    train_res = phase("train", phase_train, frame, card, profile=profile, parent_csrc=parent_csrc)
    mc_res = phase("mc", phase_mc, frame, card, holdouts)
    batch_res = phase("device-batch", phase_device_batch, card, train_res)
    md_res = phase("multi-device", phase_multi_device, frame, card)
    rel_res = phase("release", phase_release, frame, card)
    tools_res = phase("tools", phase_tools, frame, card, kpn_res, multilayer, corpus)
    bench_res = phase("bench", phase_bench, frame, card, kpn_res, hq_res, holdouts, mc_res)
    roof_res = phase("roofline", phase_roofline, card)
    exr_res = phase("exr", phase_exr, card, exr_turns)
    return (kern, soft, epilogue, ingest, kpn_res, max_res, aux_counts, per_pass_counts, uhd_res,
            feather_res, tir_res, train_kern, train_res, mc_res, batch_res, md_res, rel_res, tools_res,
            bench_res, roof_res, exr_res)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="smoke run of the PyTorch port on one CUDA card")
    ap.add_argument("--profile", action="store_true",
                    help="also print each preset's device time by kernel (torch.profiler)")
    ap.add_argument("--parent-csrc", type=Path, default=None,
                    help="csrc/ of a tree whose K1 backward writes a planar d_w: phase 16 times "
                         "its kernels beside these, phase 18's --profile counts its step's copies")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    seconds = {}

    def phase(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        seconds[name] = time.perf_counter() - t0
        log(f"[time] {name}: {seconds[name]:.1f} s")
        return out

    card = phase("card", phase_card)
    # bench.py's two holdout families at 1080p are numpy work of a minute,
    # the 1080p frame as a multilayer EXR half a minute and the input
    # pipeline's corpus a minute: one worker process makes them beside the
    # card's phases, for phases mc and tools
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        holdouts = pool.submit(_holdout_frames, FRAME_H, FRAME_W, WORK / "holdouts_1080p.pkl")
        MULTILAYER_EXR.parent.mkdir(parents=True, exist_ok=True)
        multilayer = pool.submit(_write_multilayer, MULTILAYER_EXR, FRAME_H, FRAME_W)
        corpus = pool.submit(_pipe_corpus, TRAIN_CROP)
        # the EXR codec's turns, after the multilayer EXR is written
        exr_turns = pool.submit(_exr_turns, MULTILAYER_EXR)
        res = _run_phases(phase, card, holdouts, multilayer, corpus, exr_turns, args.profile,
                          args.parent_csrc)
    kern, soft, epilogue, ingest, kpn_res, max_res, aux_counts, per_pass_counts, uhd_res, \
        feather_res, tir_res, train_kern, train_res, mc_res, batch_res, md_res, rel_res, tools_res, \
        bench_res, roof_res, exr_res = res
    log("[time] " + ", ".join(f"{k} {v:.0f}" for k, v in seconds.items()) + " s")

    group, tile, train_fwd = kern["group"], kern["tile"], kern["train"]
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
        train_shape=train_fwd["shape"], train_ms=train_fwd["ms"],
        train_plain_ms=train_fwd["plain_ms"], train_bound_ms=train_fwd["bound_ms"],
        by_shape={path: {key: t[key] for key in (
            "shape", "ms", "plain_ms", "bound_ms", "moved32_bound_ms", "moved64_bound_ms",
            "tile_rows", "resident_blocks_per_sm", "write_only_ms")}
            for path, t in (("joint", kern), ("group", group), ("tile", tile), ("train", train_fwd))},
        launches_by_path={
            "kpn-hq cli frame": kpn_res["cli_launches"],
            "flagship-max cli frame": max_res["cli_launches"]["kpn_apply"],
            "kpn-hq tiled 4K frame": uhd_res["launches"],
            "flagship-max feathered frame": feather_res["launches"]["kpn_apply"],
            "kpn-hq train step": train_res["k1_step_launches"] / TRAIN_STEPS,
            "kpn-hq traced mc frame": mc_res["kpn-hq"]["launches_per_frame"],
            "kpn-hq train step on device batches": batch_res["launches"]["kpn_apply"],
            **{f"kpn-hq 1080p frame in {n} bands": b["launches_per_frame"]
               for n, b in md_res["bands"].items()},
            f"flagship-max group frame in {md_res['group']['bands']} bands":
                md_res["group"]["launches"]["kpn_apply"],
            f"kpn-hq batch of {md_res['batch']['frames']} frames on a 4-way data mesh":
                md_res["batch"]["launches"],
            f"kpn-hq train step, each of {DP_RANKS} data-parallel ranks":
                md_res["dp_step"]["launches_per_step"]["kpn_apply"],
            "kpn TF golden (k=3, 2 slots)": rel_res["goldens"]["kpn"]["kpn_apply"],
            "kpn TF golden made by the port (k=3, 2 slots)": rel_res["made"]["kpn"]["kpn_apply"],
            "kpn-hq frame with TF round-tripped weights": rel_res["tf"]["kpn_apply"],
            "kpn-hq recipe step, teacher flagship-hq":
                rel_res["recipe"]["teacher"]["launches_per_step"]["kpn_apply"],
            "kpn-hq recipe validation batch": rel_res["recipe"]["teacher"]["launches_per_val_batch"],
            "kpn-hq cli frame with the exported npz": rel_res["export"]["kpn_apply"],
            **tools_res["k1_per_frame"],
            "tools/bench_input_pipeline kpn-hq step (fit path, device batches)":
                tools_res["bench_input_pipeline"]["launches_per_step"]["kpn_apply"],
            "tools/bench --model kpn-hq frame": bench_res["kpn-hq"]["k1_per_frame"],
            "tools/roofline kpn-hq frame": roof_res["kpn-hq"]["k1_per_frame"],
            "tools/traffic_breakdown kpn-hq op table frame":
                roof_res["traffic_breakdown"]["k1_op_table"],
        },
    )]
    for entry, fn in BWD_ENTRIES.items():
        t = train_kern[entry]
        # launches: of the first `train` call (20 steps, its eval runs no
        # backward); d_noisy has no caller on any entry point (training's
        # signal is a slice of the network input): KpnApply needs it for the
        # signal's gradient, and it is held to the plain backward only. The
        # row's own numbers are the training batch's slot 0 view; "cases"
        # holds every timed shape and view.
        kernels.append(_kernel_row(
            f"kpn_apply.{entry}", "deepdenoiser_tpu_torch/csrc/kpn_apply_bwd.cu", BWD_REPLACES,
            train_res["launches"][f"kpn_apply_{entry}"], t, on_path=entry != "bwd_noisy",
            k=t["k"], entry_point=fn, slot=t["slot"], stack=t["stack"],
            launches_per_train_step=train_res["launches"][f"kpn_apply_{entry}"] / TRAIN_STEPS,
            launches_by_path={
                "kpn-hq train step": train_res["launches"][f"kpn_apply_{entry}"] / TRAIN_STEPS,
                "kpn-hq train step on device batches": batch_res["launches"][f"kpn_apply_{entry}"],
                f"kpn-hq train step, each of {DP_RANKS} data-parallel ranks":
                    md_res["dp_step"]["launches_per_step"][f"kpn_apply_{entry}"],
                "kpn-hq recipe step, teacher flagship-hq":
                    rel_res["recipe"]["teacher"]["launches_per_step"][f"kpn_apply_{entry}"],
                "tools/bench_input_pipeline kpn-hq step (fit path, device batches)":
                    tools_res["bench_input_pipeline"]["launches_per_step"][f"kpn_apply_{entry}"],
            },
            moved32=t["moved32"], moved64=t["moved64"], moved32_bound_ms=t["moved32_bound_ms"],
            moved64_bound_ms=t["moved64_bound_ms"], buffer_sets=t["buffer_sets"],
            resident_blocks_per_sm=t["resident_blocks_per_sm"],
            stride_probe_ms=t["stride_probe_ms"],
            cases={name: {key: c[key] for key in ("shape", "slot", "ms", "plain_ms", "parent_ms",
                                                  "bound_ms", "moved32_bound_ms",
                                                  "moved64_bound_ms")}
                   for name, c in t["cases"].items()},
        ))
    # launches: of the kpn-hq cli frame, as K1's row; those of the phase's
    # own checks and timings, and of its toy heads, apart
    kernels.append(_kernel_row(
        "kpn_softmax", "deepdenoiser_tpu_torch/csrc/kpn_softmax.cu",
        "none: XLA fuses the JAX head's RMS norm and softmax", kpn_res["cli_softmax_launches"],
        soft, launches_per_frame=kpn_res["softmax_launches_per_frame"],
        launches_by_path={
            "kpn-hq cli frame": kpn_res["cli_softmax_launches"],
            "flagship-max cli frame": max_res["cli_launches"]["kpn_softmax"],
            "kpn-hq tiled 4K frame": uhd_res["softmax_launches"],
            "flagship-max feathered frame": feather_res["launches"]["kpn_softmax"],
            "kpn-hq train step on device batches": batch_res["launches"]["kpn_softmax"],
            "kpn TF golden (k=3, 2 slots)": rel_res["goldens"]["kpn"]["kpn_softmax"],
        },
        phase_launches=soft["launches"], launches_by_head=soft["head_launches"],
        by_shape={path: {key: t[key] for key in (
            "shape", "slots", "ms", "plain_ms", "bound_ms", "moved32_bound_ms", "moved64_bound_ms")}
            for path, t in soft["by_path"].items()},
    ))
    # launches: of the kpn-hq cli frame, as K1's row; each path's as its
    # phase counted them on the card
    kernels.append(_kernel_row(
        "bias_act", "deepdenoiser_tpu_torch/csrc/bias_act.cu",
        "none: XLA fuses a conv's bias and activation into the conv",
        kpn_res["cli_bias_act_launches"], epilogue,
        launches_by_path={
            "kpn-hq cli frame": kpn_res["cli_bias_act_launches"],
            "flagship-max cli frame": max_res["cli_launches"]["bias_act"],
            "kpn-hq tiled 4K frame": uhd_res["bias_act_launches"],
            "tiramisu-lt1 cli frame": tir_res["tiramisu-lt1"]["cli_bias_act_launches"],
            "flagship-max feathered frame": feather_res["launches"]["bias_act"],
            "kpn-hq train step on device batches": batch_res["launches"]["bias_act"],
        },
        by_shape={path: {key: t[key] for key in (
            "shape", "launches_per_call", "calls_per_frame", "ms", "plain_ms", "library_ms",
            "bound_ms", "largest_ms", "largest_bound_ms")} for path, t in epilogue["by_path"].items()},
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
                          "flagship-max feathered": feather_res["launches"]["group_encode"],
                          f"flagship-max in {md_res['group']['bands']} bands":
                              md_res["group"]["launches"]["group_encode"]},
        bodies_by_path={path: [ingest[b]["replaces"] for b in bodies]
                        for path, bodies in GROUP_ENCODE_BODIES.items()},
    ))
    idle = [k["name"] for k in kernels if k["launches"] < 1 and k["on_path"]]
    if idle:
        raise AssertionError(f"kernels launched on no path: {idle}")
    log(f"[done] all phases in {time.perf_counter() - t_start:.0f} s")
    log("[summary] train ms/step: kpn-hq cli {:.2f} (loader included), fit's loop body {:.2f}, "
        "make_train_step {:.2f}; flagship-hq make_train_step {:.2f} (fp32 {:.2f}); loader alone "
        "{:.2f} ms/batch".format(train_res["cli_ms"], train_res["loop_whole_ms"],
                                 train_res["kpn-hq bfloat16"]["ms"],
                                 train_res["flagship-hq bfloat16"]["ms"],
                                 train_res["flagship-hq float32"]["ms"], train_res["loader_ms"]))
    log("[summary] mc: GT {} spp at 1080p {:.2f} s; gain on the traced frame kpn-hq {:.4f} dB "
        "(fp32 {:.4f}), flagship-mc {:.4f} dB (fp32 {:.4f}); device batches: ".format(
            MC_GT_SPP, mc_res["gt_s"], mc_res["kpn-hq"]["gain_db"], mc_res["kpn-hq"]["fp32_gain_db"],
            mc_res["flagship-mc"]["gain_db"], mc_res["flagship-mc"]["fp32_gain_db"])
        + ", ".join(f"{f} {r['ms']:.2f}" for f, r in batch_res["families"].items())
        + " ms a batch; train step on mixed-mc batches {:.2f} ms (step alone {:.2f})".format(
            batch_res["ms"], batch_res["step_ms"]))
    b2, b4 = (md_res["bands"][n] for n in MD_BANDS)
    log("[summary] multi-device on one card: kpn-hq whole frame (certified halo) {:.2f} ms, "
        "{:.2f} GiB; 2 bands {:.2f} ms, {:.2f} GiB; 4 bands {:.2f} ms, {:.2f} GiB; flagship-max "
        "in 4 bands {:.2f} ms; frame batch {:.2f} ms/frame; DP step all-reduce {:.2f} ms over {}; "
        "`train` on 2 ranks {:.2f} ms/step".format(
            md_res["whole"]["ms"], md_res["whole"]["peak_gib"], b2["ms"], b2["peak_gib"], b4["ms"],
            b4["peak_gib"], md_res["group"]["ms"], md_res["batch"]["ms_per_frame"],
            md_res["dp_step"]["allreduce_ms"], md_res["dp_step"]["backend"],
            md_res["dp_cli"]["ms"]))
    rt, rp = rel_res["recipe"]["teacher"], rel_res["recipe"]["plain"]
    log("[summary] release: goldens max|d| " + ", ".join(
        f"{f} {r['max_abs_dev']:.2e}" for f, r in rel_res["goldens"].items())
        + "; made by the port (card / CPU check) " + ", ".join(
            f"{f} {r['max_abs_dev']:.2e} / {r['max_abs_dev_cpu']:.2e}"
            for f, r in rel_res["made"].items())
        + "; kpn-hq TF checkpoint {} bytes, write {:.3f} s, read {:.3f} s; recipe {:.2f} ms/step "
        "with the teacher, {:.2f} without, peak {:.2f} GiB; export {} bytes, gain {:.4f} dB".format(
            rel_res["tf"]["bytes"], rel_res["tf"]["write_s"], rel_res["tf"]["read_s"], rt["ms"],
            rp["ms"], rt["peak_gib"], rel_res["export"]["bytes"], rel_res["export"]["gain_db"]))
    bm, pipe = tools_res["bench_model"], tools_res["bench_input_pipeline"]
    log("[summary] tools: bench_model kpn-hq {:.2f} ms/frame (phase 4: {:.2f}), kpn {:.2f}; "
        "bench_4k kpn-hq ".format(bm["kpn-hq"]["latency_ms"], kpn_res["ms_median"],
                                 bm["kpn"]["latency_ms"])
        + ", ".join(f"{cfg}: {r['latency_ms_median']}" for cfg, r in tools_res["bench_4k"].items())
        + " ms/frame; bench_sequence {} ms/frame chained; input pipeline {} / {} steps/s (fit "
        "path / device batches); phase {:.0f} s".format(
            tools_res["bench_sequence"]["per_frame_ms_chained"],
            pipe["grain_2dispatch_steps_per_s"], pipe["synth_fused_steps_per_s"],
            sum(tools_res["s"].values())))
    hb, kb = bench_res["defaults"], bench_res["kpn-hq"]
    log("[summary] bench: value {} fps; flagship-hq {} ms ({:+.2f} % against phase 5), flagship {}"
        " ms, flagship-mc {} ms; kpn-hq {} ms ({:+.2f} % against phase 4); roofline mfu / "
        "hbm_utilization: ".format(hb["value"], hb["headline"]["ms"], 100 * hb["vs_phase"],
                                   hb["speed"]["ms"], hb["mc"]["ms"], kb["headline"]["ms"],
                                   100 * kb["vs_phase"])
        + ", ".join(f"{m} {roof_res[m]['mfu']} / {roof_res[m]['hbm_utilization']}"
                    for m in ROOFLINE_MODELS)
        + "; EXR read / write s: numpy {:.3f} / {:.3f}, native {:.3f} / {:.3f}".format(
            exr_res["numpy"]["read_s"], exr_res["numpy"]["write_s"],
            exr_res["native"]["read_s"], exr_res["native"]["write_s"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                             "count": card["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
