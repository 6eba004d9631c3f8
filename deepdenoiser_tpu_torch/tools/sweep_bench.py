"""Latency sweep of the 1080p group-mode pipeline over U-Net widths and
depths (the space-to-depth stem, one conv a level).

    python -m deepdenoiser_tpu_torch.tools.sweep_bench [--device cpu]

The port of tools/sweep_bench.py: the same CONFIGS, each on seeded random
parameters (eval_zoo.init_params), on bench.py's Fourier frame at spp 8.
measure() prints one line a config: its ms a frame, the median of 3
samples of K frames timed by CUDA events (tools/_timing.py). A config
that fails prints FAILED and the sweep goes on. Runs on the card unless
--device cpu is given.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, List, Mapping

import numpy as np

from deepdenoiser_tpu_torch import device as device_lib
from deepdenoiser_tpu_torch import transforms
from deepdenoiser_tpu_torch.config import InferenceConfig
from deepdenoiser_tpu_torch.data import synthetic
from deepdenoiser_tpu_torch.inference import pipeline
from deepdenoiser_tpu_torch.models.factory import ModelConfig
from deepdenoiser_tpu_torch.tools import _timing, eval_zoo

H, W = 1080, 1920
K = 6
SAMPLES = 3

_BASE = dict(backbone="unet", in_channels=transforms.group_input_channels(), out_channels=6,
             compute_dtype="bfloat16")
# (model, tile): whole-frame s2d, one conv a level
CONFIGS = [
    (ModelConfig(**_BASE, base_width=48, depth=3, convs_per_level=1, stem_stride=2), 0),
    (ModelConfig(**_BASE, base_width=96, depth=3, convs_per_level=1, stem_stride=2), 0),
    (ModelConfig(**_BASE, base_width=128, depth=3, convs_per_level=1, stem_stride=2), 0),
    (ModelConfig(**_BASE, base_width=64, depth=4, convs_per_level=1, stem_stride=2), 0),
    (ModelConfig(**_BASE, base_width=96, depth=4, convs_per_level=1, stem_stride=2), 0),
]


def bench_frame(height: int, width: int, device) -> dict:
    """bench.py's Fourier frame at spp 8, on `device`."""
    clean = synthetic.generate_clean_passes(height, width, seed=0)
    return eval_zoo.to_device(synthetic.add_mc_noise(clean, spp=8, seed=1), device)


def measure(mcfg: ModelConfig, tile: int, frame: Mapping[str, Any], device=None) -> float:
    """ms a group-mode frame of H x W for `mcfg` with `tile`."""
    dev = device_lib.resolve(device)
    icfg = InferenceConfig(tile=tile, compute_dtype="bfloat16")
    denoise, grid = pipeline.make_group_frame_denoiser(mcfg, icfg, H, W,
                                                       eval_zoo.init_params(mcfg), device=dev)
    ms = float(np.median(_timing.per_frame_ms(lambda: denoise(frame), K, SAMPLES, dev)))
    print(f"tile={tile:4d} halo={grid.halo:3d} net={grid.net_h}x{grid.net_w} "
          f"tiles={grid.n_tiles:3d} bw={mcfg.base_width:3d} d={mcfg.depth} "
          f"cpl={mcfg.convs_per_level} s2d={mcfg.stem_stride == 2} "
          f"-> {ms:7.2f} ms/frame", flush=True)
    return ms


def main(argv: List[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)
    dev = device_lib.resolve(args.device)
    frame = bench_frame(H, W, dev)
    for mcfg, tile in CONFIGS:
        try:
            measure(mcfg, tile, frame, dev)
        except Exception as e:  # noqa: BLE001 — a sweep reports each config
            print(f"FAILED {mcfg.base_width}/{tile}: {type(e).__name__} {e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
