"""flagship-mc's bf16 against fp32 PSNR gain on a traced frame, in both
packages on the CPU (a script, not collected by pytest):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_flagship_mc_bf16_gap.py 540 960 1024

renders bench.py's MC frame with the JAX tracer (make_scene(0), GT at the
given spp, the 4-spp estimate of sample seed 4) at H x W, and denoises it
with the release flagship-mc weights through the JAX package's joint
pipeline and the port's, each in bf16 and in fp32, whole frame with the
32 px border. Prints the four tonemapped PSNR gains and each package's
bf16 - fp32 gap. Memory grows with H x W: a quarter of 1080p needs a few
GiB.
"""

import argparse
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from deepdenoiser_tpu.config import InferenceConfig as JInferenceConfig
from deepdenoiser_tpu.data import mc_tracer as jmc
from deepdenoiser_tpu.inference import pipeline as jpipeline
from deepdenoiser_tpu.ops import metrics as jmetrics
from deepdenoiser_tpu_torch import config, weights_io
from deepdenoiser_tpu_torch.inference import pipeline
from deepdenoiser_tpu_torch.ops import metrics
from tools.export_release_weights import load_release_params
from tools.pretrain_flagship import UNET_FULLRES

WEIGHTS = "weights/flagship_mc_ema_f16.npz"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("height", type=int)
    ap.add_argument("width", type=int)
    ap.add_argument("gt_spp", type=int)
    args = ap.parse_args()
    h, w = args.height, args.width
    clean = jmc.generate_clean_passes(h, w, seed=0, spp=args.gt_spp)
    noisy = {k: np.array(v) for k, v in
             jmc.generate_noisy_passes(h, w, seed=0, spp=4, sample_seed=4).items()}

    gains = {}
    ref = jmetrics.tonemap_for_metrics(jnp.asarray(clean["combined"]))[None]
    base = float(jmetrics.psnr(jmetrics.tonemap_for_metrics(jnp.asarray(noisy["combined"]))[None], ref))
    jparams = load_release_params(WEIGHTS)
    for dtype in ("bfloat16", "float32"):
        den, _ = jpipeline.make_joint_frame_denoiser(
            dataclasses.replace(UNET_FULLRES, compute_dtype=dtype),
            JInferenceConfig(tile=0, border=32, compute_dtype=dtype), h, w)
        out = den(jparams, {k: jnp.asarray(v) for k, v in noisy.items()})["combined"]
        gains["jax", dtype] = float(jmetrics.psnr(jmetrics.tonemap_for_metrics(out)[None], ref)) - base

    cfg = config.validate_channels(config.PRESETS["flagship-mc"])
    params = weights_io.load_release_params(WEIGHTS)
    tref = metrics.tonemap_for_metrics(torch.from_numpy(np.array(clean["combined"])))[None]
    tbase = float(metrics.psnr(metrics.tonemap_for_metrics(torch.from_numpy(noisy["combined"]))[None], tref))
    for dtype in ("bfloat16", "float32"):
        infer = dataclasses.replace(cfg.infer, tile=0, compute_dtype=dtype)
        den, _ = pipeline.make_joint_frame_denoiser(cfg.model, infer, h, w, params, device="cpu")
        out = den(noisy)["combined"]
        gains["port", dtype] = float(metrics.psnr(metrics.tonemap_for_metrics(out)[None], tref)) - tbase

    print(f"{h}x{w}, GT {args.gt_spp} spp, noisy 4 spp: PSNR gain, dB")
    for pkg in ("jax", "port"):
        bf, fp = gains[pkg, "bfloat16"], gains[pkg, "float32"]
        print(f"  {pkg:4s}  bf16 {bf:.4f}  fp32 {fp:.4f}  bf16 - fp32 {bf - fp:+.4f}")


if __name__ == "__main__":
    main()
