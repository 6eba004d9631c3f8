"""A torch.profiler trace of the 1080p frame pipeline (SURVEY.md §5).

    python -m deepdenoiser_tpu_torch.tools.profile [--out build/trace] [--iters 3] \\
        [--height 1080 --width 1920] [--device cpu]

The port of tools/profile.py: the flagship (tools/pretrain_flagship
.FLAGSHIP) on seeded random parameters (eval_zoo.init_params), joint mode,
whole frame, bf16, on bench.py's Fourier frame at spp 8; one denoise
outside the trace (kernel builds, cuDNN's choices), then --iters frames,
each under record_function("frame_<i>"), host and device activity. Writes
a Chrome trace, <out>/trace.json (chrome://tracing or Perfetto), and
prints the device time by kernel. Runs on the card unless --device cpu is
given.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from deepdenoiser_tpu_torch import device as device_lib
from deepdenoiser_tpu_torch.config import InferenceConfig
from deepdenoiser_tpu_torch.data import synthetic
from deepdenoiser_tpu_torch.inference import pipeline
from deepdenoiser_tpu_torch.tools import eval_zoo
from deepdenoiser_tpu_torch.tools.pretrain_flagship import FLAGSHIP, REPO_ROOT


def main(argv: List[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=str(REPO_ROOT / "build" / "trace"))
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)
    dev = device_lib.resolve(args.device)

    icfg = InferenceConfig(tile=0, compute_dtype="bfloat16")
    denoise, _ = pipeline.make_joint_frame_denoiser(
        FLAGSHIP, icfg, args.height, args.width, eval_zoo.init_params(FLAGSHIP), device=dev)
    clean = synthetic.generate_clean_passes(args.height, args.width, seed=0)
    frame = eval_zoo.to_device(synthetic.add_mc_noise(clean, spp=8, seed=1), dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    denoise(frame)  # outside the trace
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=activities) as prof:
        for i in range(args.iters):
            with record_function(f"frame_{i}"):
                denoise(frame)
                sync()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trace = out / "trace.json"
    prof.export_chrome_trace(str(trace))
    sort = "self_cuda_time_total" if dev.type == "cuda" else "self_cpu_time_total"
    print(prof.key_averages().table(sort_by=sort, row_limit=15))
    print(f"trace written to {trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
