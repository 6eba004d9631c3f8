"""Family-generalization evaluation: the PSNR/SSIM gain of the shipped
flagship on (a) the training families (Fourier fields, data/synthetic.py;
Voronoi scenes, data/synthetic_holdout.py) and (b) the structurally
different untouched holdouts (ray-traced spheres, data/synthetic_spheres.py;
boxes, data/synthetic_boxes.py), at matching Monte-Carlo noise levels.
Prints a table and one JSON line {"eval_holdout": [...]}.

    python -m deepdenoiser_tpu_torch.tools.eval_holdout [--height 1080 --width 1920] \\
        [--frames 3] [--spp 4 8] [--weights weights/flagship_ema_f16.npz] [--device cpu]

The port of tools/eval_holdout.py: the same frames (host numpy, seeds
1000+f, add_mc_noise(spp, seed=7f+spp)) through inference/sequence
.run_sequence with the flagship (tools/pretrain_flagship.FLAGSHIP);
latency_ms is that harness's per-frame median. Runs on the card unless
--device cpu is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List

import numpy as np
import torch

from deepdenoiser_tpu_torch import device as device_lib
from deepdenoiser_tpu_torch import weights_io
from deepdenoiser_tpu_torch.config import InferenceConfig
from deepdenoiser_tpu_torch.data import (synthetic, synthetic_boxes, synthetic_holdout,
                                         synthetic_spheres)
from deepdenoiser_tpu_torch.inference import sequence
from deepdenoiser_tpu_torch.ops import metrics
from deepdenoiser_tpu_torch.tools.pretrain_flagship import FLAGSHIP, WEIGHTS_DIR

FAMILIES = {
    "train (fourier)": synthetic.generate_clean_passes,
    "train (voronoi, r3)": synthetic_holdout.generate_clean_passes,
    "holdout (spheres)": synthetic_spheres.generate_clean_passes,
    "holdout2 (boxes, r4)": synthetic_boxes.generate_clean_passes,
}


def main(argv: List[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--frames", type=int, default=3)
    p.add_argument("--spp", type=int, nargs="+", default=[4, 8])
    p.add_argument("--weights", default=str(WEIGHTS_DIR / "flagship_ema_f16.npz"))
    p.add_argument("--tile", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)
    dev = device_lib.resolve(args.device)

    params = weights_io.load_release_params(args.weights)
    icfg = InferenceConfig(tile=args.tile, compute_dtype="bfloat16")
    tm = metrics.tonemap_for_metrics

    rows = []
    for fam_name, gen in FAMILIES.items():
        for spp in args.spp:
            frames, gts = [], []
            for f in range(args.frames):
                clean = gen(args.height, args.width, seed=1000 + f)
                frames.append(synthetic.add_mc_noise(clean, spp=spp, seed=7 * f + spp))
                gts.append(clean["combined"])
            rep = sequence.run_sequence(FLAGSHIP, icfg, params, frames, gts, mode="joint",
                                        device=dev)
            # the noisy input's PSNR anchors the gain
            base = float(np.mean([
                float(metrics.psnr(tm(torch.as_tensor(f["combined"], device=dev)),
                                   tm(torch.as_tensor(g, device=dev))))
                for f, g in zip(frames, gts)
            ]))
            rows.append({
                "family": fam_name, "spp": spp,
                "noisy_psnr": round(base, 2),
                "denoised_psnr": round(rep["psnr_mean"], 2),
                "gain_db": round(rep["psnr_mean"] - base, 2),
                "ssim": round(rep["ssim_mean"], 4),
                "latency_ms": round(rep["latency_ms_median"], 1),
            })
            print(f"{fam_name:26s} spp={spp:<3d} noisy={base:6.2f} dB  "
                  f"denoised={rep['psnr_mean']:6.2f} dB  "
                  f"gain={rep['psnr_mean'] - base:+5.2f} dB  "
                  f"ssim={rep['ssim_mean']:.4f}", flush=True)

    print(json.dumps({"eval_holdout": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
