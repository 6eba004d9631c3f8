"""4K animation-sequence batch denoise with per-frame latency and PSNR/SSIM
(BASELINE config #5).

    python -m deepdenoiser_tpu_torch.tools.bench_4k [--frames 4] [--tile 0] [--spp 4] \\
        [--model flagship] [--device cpu]

The port of tools/bench_4k.py. The frames are made on the device
(data/synthetic_device.py): one Fourier-family scene from
draws.seeded(0), and frame i's Monte-Carlo noise from draws.seeded(100+i).
The draws are torch's, not threefry's, so these are other samples of the
JAX tool's family. A frame's latency is the denoise alone: 4 denoises of
it between CUDA events after a warm-up, per frame (tools/_timing.py);
PSNR and SSIM are computed on the device. --tile, --tile-batch, --halo
and --border mean what they mean in inference/tiled.py and
InferenceConfig. Joint-mode zoo models only, with the weights
tools/eval_zoo.load_model_params finds. Runs on the card unless --device
cpu is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

import numpy as np
import torch

from deepdenoiser_tpu_torch import device as device_lib
from deepdenoiser_tpu_torch.config import InferenceConfig
from deepdenoiser_tpu_torch.data import draws, synthetic_device
from deepdenoiser_tpu_torch.inference import pipeline
from deepdenoiser_tpu_torch.tools import _timing, eval_zoo

SCENE_SEED = 0
NOISE_SEED = 100  # + the frame's index
CHAIN = 4  # denoises timed per frame


def clean_frame(height: int, width: int, device) -> Dict[str, torch.Tensor]:
    """The scene's clean (height, width, C) passes, made on `device`."""
    clean = synthetic_device.generate_clean_passes(draws.seeded(SCENE_SEED, device), 1,
                                                   height, width)
    return {k: v[0] for k, v in clean.items()}


def noisy_frame(clean: Dict[str, torch.Tensor], index: int, spp: float) -> Dict[str, torch.Tensor]:
    """Frame `index`'s noisy realization of `clean`, on clean's device."""
    dev = clean["combined"].device
    return synthetic_device.add_mc_noise(draws.seeded(NOISE_SEED + index, dev), clean, spp)


def main(argv: List[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--height", type=int, default=2160)
    p.add_argument("--width", type=int, default=3840)
    p.add_argument("--tile", type=int, default=0)
    p.add_argument("--tile-batch", type=int, default=0,
                   help="tiles per network call, to bound device memory (0 = all)")
    p.add_argument("--halo", type=int, default=0, help="override the certified halo (tiled modes)")
    p.add_argument("--border", type=int, default=32,
                   help="whole-frame reflect border; -1 = the certified halo")
    p.add_argument("--spp", type=float, default=4.0)
    p.add_argument("--model", default="flagship",
                   help="joint-mode zoo model (weights as eval_zoo.load_model_params finds them)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)
    dev = device_lib.resolve(args.device)

    h, w = args.height, args.width
    mcfg, params, mode = eval_zoo.load_model_params(args.model)
    if mode != "joint":
        raise SystemExit(f"bench_4k drives the joint pipeline; {args.model} is a {mode} model")
    icfg = InferenceConfig(tile=args.tile, tile_batch=args.tile_batch, halo=args.halo,
                           border=args.border, compute_dtype="bfloat16")
    denoise, grid = pipeline.make_joint_frame_denoiser(mcfg, icfg, h, w, params, device=dev)
    print(f"model: {args.model}; grid: {grid}", file=sys.stderr, flush=True)

    clean = clean_frame(h, w, dev)
    gt = clean["combined"]
    lat, psnrs, ssims, psnr_noisy = [], [], [], []
    for i in range(args.frames):
        noisy = noisy_frame(clean, i, args.spp)
        lat.append(_timing.per_frame_ms(lambda: denoise(noisy), CHAIN, 1, dev, warmup=1)[0])
        pd, sd, pn = eval_zoo.quality(denoise(noisy)["combined"], noisy["combined"], gt)
        psnrs.append(float(pd))
        ssims.append(float(sd))
        psnr_noisy.append(float(pn))
        del noisy

    print(json.dumps({
        "model": args.model,
        "resolution": f"{w}x{h}",
        "spp": args.spp,
        "n_frames": args.frames,
        "latency_ms": [round(x, 1) for x in lat],
        "latency_ms_median": round(float(np.median(lat)), 1),
        "psnr_noisy_mean": round(float(np.mean(psnr_noisy)), 2),
        "psnr_mean": round(float(np.mean(psnrs)), 2),
        "ssim_mean": round(float(np.mean(ssims)), 4),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
