"""Latency sweep of the 1080p joint-group pipeline (all four light groups
in one network pass) over U-Net widths and convs a level (the
space-to-depth stem).

    python -m deepdenoiser_tpu_torch.tools.sweep_joint [--device cpu]

The port of tools/sweep_joint.py: the same CONFIGS, each on seeded random
parameters (eval_zoo.init_params), on bench.py's Fourier frame at spp 8
(sweep_bench.bench_frame). measure() prints one line a config: its ms a
frame, the median of 3 samples of K frames timed by CUDA events
(tools/_timing.py). A config that fails prints FAILED and the sweep goes
on. Runs on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, List, Mapping

import numpy as np

from deepdenoiser_tpu_torch import device as device_lib
from deepdenoiser_tpu_torch import transforms
from deepdenoiser_tpu_torch.config import InferenceConfig
from deepdenoiser_tpu_torch.inference import pipeline
from deepdenoiser_tpu_torch.models.factory import ModelConfig
from deepdenoiser_tpu_torch.tools import _timing, eval_zoo, sweep_bench

H, W = 1080, 1920
K = 6
SAMPLES = 3

_BASE = dict(backbone="unet", in_channels=transforms.joint_input_channels(),
             out_channels=transforms.joint_output_channels(), compute_dtype="bfloat16")
CONFIGS = [
    ModelConfig(**_BASE, base_width=64, depth=3, convs_per_level=1, stem_stride=2),
    ModelConfig(**_BASE, base_width=96, depth=3, convs_per_level=1, stem_stride=2),
    ModelConfig(**_BASE, base_width=64, depth=3, convs_per_level=2, stem_stride=2),
    ModelConfig(**_BASE, base_width=96, depth=3, convs_per_level=2, stem_stride=2),
    ModelConfig(**_BASE, base_width=128, depth=3, convs_per_level=2, stem_stride=2),
]


def measure(mcfg: ModelConfig, frame: Mapping[str, Any], device=None) -> float:
    """ms a joint-mode frame of H x W for `mcfg`, whole frame."""
    dev = device_lib.resolve(device)
    icfg = InferenceConfig(tile=0, compute_dtype="bfloat16")
    denoise, grid = pipeline.make_joint_frame_denoiser(mcfg, icfg, H, W,
                                                       eval_zoo.init_params(mcfg), device=dev)
    ms = float(np.median(_timing.per_frame_ms(lambda: denoise(frame), K, SAMPLES, dev)))
    print(f"JOINT halo={grid.halo:3d} net={grid.net_h}x{grid.net_w} "
          f"bw={mcfg.base_width:3d} d={mcfg.depth} cpl={mcfg.convs_per_level} "
          f"s2d={mcfg.stem_stride == 2} -> {ms:7.2f} ms/frame", flush=True)
    return ms


def main(argv: List[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)
    dev = device_lib.resolve(args.device)
    frame = sweep_bench.bench_frame(H, W, dev)
    for mcfg in CONFIGS:
        try:
            measure(mcfg, frame, dev)
        except Exception as e:  # noqa: BLE001 — a sweep reports each config
            print(f"FAILED bw{mcfg.base_width}: {type(e).__name__} {e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
