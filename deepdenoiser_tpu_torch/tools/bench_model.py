"""Per-model 1080p latency of one zoo model's frame denoise, with the
quality of the same program, on bench.py's frame (the Fourier family,
generate_clean_passes(H, W, seed=0), add_mc_noise(spp=4, seed=1)).

    python -m deepdenoiser_tpu_torch.tools.bench_model --model kpn-hq \\
        [--border 32] [--tile 0 --tile-batch 0] [--chain 8 --samples 5] [--init] [--device cpu]

The port of tools/bench_model.py. Joint or group mode by the model's
output width (inference/sequence.make_mode_denoiser); weights as
tools/eval_zoo.load_model_params finds them, or
seeded random ones with --init (latency-only sweeps of untrained
variants: the quality numbers are then meaningless). latency_ms is the
median over --samples samples of the per-frame ms of --chain frames,
timed by CUDA events after a warm-up (tools/_timing.py); samples_ms lists
each sample. Runs on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List

import numpy as np
import torch

from deepdenoiser_tpu_torch import device as device_lib
from deepdenoiser_tpu_torch.config import InferenceConfig
from deepdenoiser_tpu_torch.data import synthetic
from deepdenoiser_tpu_torch.inference import sequence
from deepdenoiser_tpu_torch.tools import _timing, eval_zoo
from deepdenoiser_tpu_torch.tools.pretrain_flagship import MODELS, MODES


def main(argv: List[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, choices=sorted(MODELS))
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--border", type=int, default=32)
    p.add_argument("--tile", type=int, default=0)
    p.add_argument("--tile-batch", type=int, default=0)
    p.add_argument("--chain", type=int, default=8, help="frames per timed sample")
    p.add_argument("--samples", type=int, default=5)
    p.add_argument("--init", action="store_true",
                   help="seeded random parameters instead of loading weights (latency-only "
                        "sweeps of untrained variants; the quality numbers are meaningless)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)
    dev = device_lib.resolve(args.device)

    h, w = args.height, args.width
    if args.init:
        mcfg = MODELS[args.model]
        params, mode = eval_zoo.init_params(mcfg), MODES[mcfg.out_channels]
    else:
        mcfg, params, mode = eval_zoo.load_model_params(args.model)
    icfg = InferenceConfig(tile=args.tile, tile_batch=args.tile_batch,
                           compute_dtype="bfloat16", border=args.border)
    denoise, grid = sequence.make_mode_denoiser(mcfg, icfg, h, w, params, mode, device=dev)
    print(f"{args.model}: grid {grid.net_h}x{grid.net_w} mode={mode} device={dev}",
          file=sys.stderr, flush=True)

    clean = synthetic.generate_clean_passes(h, w, seed=0)
    frame = eval_zoo.to_device(synthetic.add_mc_noise(clean, spp=4, seed=1), dev)
    gt = torch.as_tensor(clean["combined"], device=dev)

    per_frame = _timing.per_frame_ms(lambda: denoise(frame), args.chain, args.samples, dev)
    pd, sd, pn = (float(x) for x in eval_zoo.quality(denoise(frame)["combined"],
                                                     frame["combined"], gt))
    print(json.dumps({
        "model": args.model, "mode": mode,
        "latency_ms": round(float(np.median(per_frame)), 2),
        "samples_ms": [round(x, 1) for x in per_frame],
        "psnr": round(pd, 2), "noisy_psnr": round(pn, 2),
        "gain_db": round(pd - pn, 2), "ssim": round(sd, 4),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
