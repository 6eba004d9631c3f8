"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Drives the port's main path — the joint-mode whole-frame denoise of the
kpn-hq preset at 1080p, through `deepdenoiser-torch denoise` (cli.main) and
through make_joint_frame_denoiser — and checks every CUDA kernel of that
path against its plain PyTorch version on the card. Phases, each printing
its results on its own lines; any failure raises and the run exits
non-zero:

  1. card       name, count, power limit; fails without a CUDA device
  2. build      nvcc every csrc/*.cu (ops/_build.py), ptxas report
  3. kernels    each kernel vs its plain version at the main path's shapes
                (max|Δ| <= 1e-5 + 1e-5·|ref|), CUDA-event times, bound
  4. kpn-hq     1080p frame, release weights: 8 KPN launches per frame,
                finite output, PSNR gain > 0 and within 0.05 dB of the same
                frame in fp32 (TF32 off, plain filter apply), ms per frame
  5. flagship-hq the same path (no kernel of its own), gain and ms per frame
  6. one JSON line {"kernels": [...]}
  (with --profile, phases 4 and 5 also print device time by kernel and the
  device's busy share, from torch.profiler)
  then the card's name and power limit as nvidia-smi prints them, and last
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Imports nothing of JAX or of the JAX package. Builds into build/ (listed
in .gitignore) and writes its scratch frame there.
"""

from __future__ import annotations

import argparse
import json
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
TOL_ABS = TOL_REL = 1e-5  # same fp32 taps in the same order; FMA contraction
GAIN_TOL_DB = 0.05
FRAME_H, FRAME_W = 1080, 1920
TIMED_FRAMES = 10


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
        for line in _build.ptxas_report(name).splitlines():
            log(f"[build] {name}: {line.strip()}")


def _kpn_inputs(shape, k, main_layout, gen):
    """noisy (N,H,W,C) and softmaxed weights (N,H,W,k²) on the card. With
    main_layout, as the pipeline hands them to the kernel: the noisy slot
    is a 3-channel slice of a 24-channel signal stack and the weights a
    view of planar (N,k²,H,W) softmax output."""
    n, h, w, c = shape
    dev = "cuda"
    if main_layout:
        stack = torch.rand((n, h, w, 24), generator=gen, device=dev)
        noisy = stack[..., 9:12]
        logits = torch.randn((n, k * k, h, w), generator=gen, device=dev)
        weights = torch.softmax(logits, dim=1).permute(0, 2, 3, 1)
    else:
        noisy = torch.rand(shape, generator=gen, device=dev)
        logits = torch.randn((n, h, w, k * k), generator=gen, device=dev)
        weights = torch.softmax(logits, dim=-1)
    return noisy, weights


def phase_kernels(card: dict) -> dict:
    from deepdenoiser_tpu_torch.models import kpn
    from deepdenoiser_tpu_torch.ops import kpn_apply

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = [((1, 1144, 1984, 3), 5, True), ((4, 260, 390, 3), 3, False),
             ((1, 37, 53, 3), 5, False)]
    worst = 0.0
    timing = None
    for shape, k, main_layout in cases:
        noisy, weights = _kpn_inputs(shape, k, main_layout, gen)
        got = kpn_apply.apply_cuda(noisy, weights, k)
        ref = kpn.apply_per_pixel_kernels(noisy, weights, k)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        bad = int((err > TOL_ABS + TOL_REL * ref.abs()).sum())
        max_err = float(err.max())
        worst = max(worst, max_err)
        log(f"[kernels] kpn_apply {shape} k={k} main_layout={main_layout}: "
            f"max|d|={max_err:.3e} over tolerance={bad}")
        if bad or not torch.isfinite(got).all():
            raise AssertionError(f"kpn_apply disagrees with its plain version at {shape} k={k}")
        if timing is None:  # the main path's shape
            n, h, w, c = shape
            kernel_ms = cuda_ms(lambda: kpn_apply.apply_cuda(noisy, weights, k), iters=200)
            plain_ms = cuda_ms(lambda: kpn.apply_per_pixel_kernels(noisy, weights, k), iters=20)
            px = n * h * w
            nbytes = px * (c + k * k + c) * 4  # each input read once, output written once
            flops = px * c * k * k * 2
            bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
            ops_ms = flops / H100_FP32_FLOP_PER_S * 1e3
            timing = {
                "shape": list(shape), "k": k, "ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "flops": flops,
            }
            log(f"[kernels] kpn_apply {shape} k={k}: {kernel_ms * 1e3:.1f} us/launch "
                f"(bound {timing['bound_ms'] * 1e3:.1f} us by {timing['bound_by']}: "
                f"{nbytes / 1e6:.1f} MB at 3.35 TB/s = {bytes_ms * 1e3:.1f} us, "
                f"{flops / 1e9:.3f} GFLOP at 67 TFLOP/s = {ops_ms * 1e3:.1f} us; "
                f"{nbytes / (kernel_ms * 1e-3) / 1e12:.2f} TB/s achieved), "
                f"plain version {plain_ms * 1e3:.1f} us | {card['smi']}")
        del noisy, weights, got, ref, err
    timing["max_abs_err"] = worst
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


def phase_preset(preset: str, weights: str, frame: dict, card: dict,
                 kernel_launches_per_frame: int, check_fp32: bool,
                 profile: bool = False) -> dict:
    import dataclasses

    from deepdenoiser_tpu_torch import cli, config, weights_io
    from deepdenoiser_tpu_torch.data import exr
    from deepdenoiser_tpu_torch.inference import pipeline
    from deepdenoiser_tpu_torch.models import kpn
    from deepdenoiser_tpu_torch.ops import kpn_apply

    clean, noisy, frame_dir = frame["clean"], frame["noisy"], frame["dir"]
    dev = torch.device("cuda")
    clean_c = torch.from_numpy(clean["combined"]).to(dev)
    noisy_c = torch.from_numpy(noisy["combined"]).to(dev)
    wpath = str(ROOT / "weights" / weights)
    res = {"preset": preset}

    # the user's entry point: deepdenoiser-torch denoise (runs on cuda by default)
    out_exr = WORK / f"{preset}_combined.exr"
    kpn_apply.reset_launches()
    rc = cli.main(["denoise", "--preset", preset, "--weights", wpath,
                   "--frame", str(frame_dir), "--out", str(out_exr), "--mode", "joint"])
    torch.cuda.synchronize()
    res["cli_launches"] = kpn_apply.launches
    if rc != 0:
        raise AssertionError(f"{preset}: cli denoise returned {rc}")
    if res["cli_launches"] != kernel_launches_per_frame:
        raise AssertionError(f"{preset}: cli frame launched kpn_apply {res['cli_launches']} "
                             f"times, want {kernel_launches_per_frame}")
    cli_out = torch.from_numpy(exr.read_exr(out_exr)).to(dev)
    if tuple(cli_out.shape) != (FRAME_H, FRAME_W, 3) or not torch.isfinite(cli_out).all():
        raise AssertionError(f"{preset}: cli output {tuple(cli_out.shape)} not finite/shaped")
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
    kpn_apply.reset_launches()
    times = []
    for _ in range(TIMED_FRAMES):
        t0 = time.perf_counter()
        out = denoise(frame_dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = kpn_apply.launches
    if launches != kernel_launches_per_frame * TIMED_FRAMES:
        raise AssertionError(f"{preset}: {launches} kpn_apply launches over {TIMED_FRAMES} "
                             f"frames, want {kernel_launches_per_frame} per frame")
    comb = out["combined"]
    if tuple(comb.shape) != (FRAME_H, FRAME_W, 3) or not all(
        torch.isfinite(v).all() for v in out.values()
    ):
        raise AssertionError(f"{preset}: output not finite / wrong shape {tuple(comb.shape)}")
    res.update(
        grid=f"{grid.net_h}x{grid.net_w} (halo {grid.halo})",
        gain_db=_gain_db(comb, noisy_c, clean_c),
        ms_median=statistics.median(times), ms_min=min(times), ms_max=max(times),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches_per_frame=launches / TIMED_FRAMES,
    )
    if res["gain_db"] <= 0 or res["cli_gain_db"] <= 0:
        raise AssertionError(f"{preset}: no PSNR gain ({res['gain_db']}, cli {res['cli_gain_db']})")
    del out, comb

    if check_fp32:
        # fp32 reference: full-precision convs (TF32 off for cuDNN and
        # matmuls) and the plain filter apply instead of the kernel
        prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            icfg = dataclasses.replace(cfg.infer, compute_dtype="float32")
            ref_fn, _ = pipeline.make_joint_frame_denoiser(cfg.model, icfg, FRAME_H, FRAME_W, params)
            if cfg.model.kernel_prediction:
                ref_fn.model.KernelPredictionHead_0.filter_apply = kpn.apply_per_pixel_kernels
            ref_out = ref_fn(frame_dev)["combined"]
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
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
        f"{res['ms_median']:.2f} ms/frame median of {TIMED_FRAMES} "
        f"(min {res['ms_min']:.2f}, max {res['ms_max']:.2f}; host clock around synchronize), "
        f"peak {res['peak_gib']:.2f} GiB | {card['smi']}")
    log(f"[{preset}] PSNR gain {res['gain_db']:.4f} dB (cli {res['cli_gain_db']:.4f} dB"
        + (f", fp32 reference {res['fp32_gain_db']:.4f} dB" if check_fp32 else "")
        + f"); kpn_apply launches: cli frame {res['cli_launches']}, "
        f"{res['launches_per_frame']:g} per timed frame")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="smoke run of the PyTorch port on one CUDA card")
    ap.add_argument("--profile", action="store_true",
                    help="also print each preset's device time by kernel (torch.profiler)")
    args = ap.parse_args(argv)
    card = phase_card()
    phase_build()
    kern = phase_kernels(card)

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

    kernels = [{
        "name": "kpn_apply",
        "route": "cuda",
        "source": "deepdenoiser_tpu_torch/csrc/kpn_apply.cu",
        "replaces": "deepdenoiser_tpu/ops/kpn_pallas.py:59",
        "launches": kpn_res["cli_launches"],
        "launches_per_frame": kpn_res["launches_per_frame"],
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "library_ms": None,  # no single PyTorch call computes it
        "us": kern["ms"] * 1e3,
        "bound_us": kern["bound_ms"] * 1e3,
        "shape": kern["shape"],
        "k": kern["k"],
        "bytes": kern["bytes"],
        "flops": kern["flops"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                             "count": card["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
