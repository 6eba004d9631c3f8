"""Multi-scale Voronoi-anomaly probe.

The multiscale model's Voronoi gain was anomalously weak against its
Fourier and holdout gains. Hypothesis: the coarse-scale corrections,
`out = fine + up(coarse - down(fine))`, hurt on Voronoi's sharp cell
edges. The same parameters run at any scale count, so denoising with
n_scales = 3, 2, 1 isolates the composition's share per family with no
retraining.

    python -m deepdenoiser_tpu_torch.tools.diag_multiscale [--height 512 --width 768] \\
        [--frames 2] [--spp 4] [--device cpu]

The port of tools/diag_multiscale.py: the multiscale model's weights from
eval_zoo.load_model_params("multiscale"), the four host families of
eval_zoo.family_frames, the mean PSNR gain per family and scale count, one
JSON line {"multiscale_diag": [...]}. The JAX tool forced the CPU so as
to keep off a TPU that was training; this one runs on the card unless
--device cpu is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List

import numpy as np

from deepdenoiser_tpu_torch import device as device_lib
from deepdenoiser_tpu_torch.config import InferenceConfig
from deepdenoiser_tpu_torch.inference import pipeline
from deepdenoiser_tpu_torch.tools import eval_zoo

FAMILY_NAMES = {"train-family": "fourier", "voronoi": "voronoi", "holdout": "spheres",
                "holdout2": "boxes"}


def main(argv: List[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=768)
    p.add_argument("--frames", type=int, default=2)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)
    dev = device_lib.resolve(args.device)

    h, w = args.height, args.width
    mcfg3, params, mode = eval_zoo.load_model_params("multiscale")
    if mode != "joint":
        raise SystemExit(f"the multiscale model is a {mode} model; the probe drives joint mode")
    icfg = InferenceConfig(tile=0, compute_dtype="bfloat16")
    families = {FAMILY_NAMES[fam]: eval_zoo.on_device(frames, dev)
                for fam, frames in eval_zoo.family_frames(h, w, args.frames, args.spp).items()}

    rows = []
    for n_scales in (3, 2, 1):
        mcfg = dataclasses.replace(mcfg3, n_scales=n_scales)
        denoise, _ = pipeline.make_joint_frame_denoiser(mcfg, icfg, h, w, params, device=dev)
        row = {"n_scales": n_scales}
        for fam, frames in families.items():
            gains = []
            for noisy, gt in frames:
                pd, _, pn = eval_zoo.quality(denoise(noisy)["combined"], noisy["combined"], gt)
                gains.append(float(pd) - float(pn))
            row[fam] = round(float(np.mean(gains)), 2)
        rows.append(row)
        del denoise
        print(f"n_scales={n_scales}: " + "  ".join(f"{f} {row[f]:+.2f}" for f in families),
              flush=True)

    print(json.dumps({"multiscale_diag": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
