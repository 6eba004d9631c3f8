"""Architecture ablation (SURVEY.md C12/C13/C14): zoo challengers against
the flagship — 1080p denoise latency, plus PSNR/SSIM gain on the training
synthetic families and on the structurally different holdout families.

    python -m deepdenoiser_tpu_torch.tools.pretrain_flagship --model multiscale \\
        --steps 40000 --out checkpoints/multiscale
    ... (tiramisu, kpn) ...
    python -m deepdenoiser_tpu_torch.tools.eval_zoo --models flagship multiscale tiramisu kpn \\
        [--quality-only] [--no-mc] [--device cpu]

The port of tools/eval_zoo.py. Prints one table row per model and one
JSON line {"zoo": [...]} with the JAX tool's keys. A model's parameters
come from its release file weights/<name>_ema_f16.npz, else from the
newest checkpoint under checkpoints/<name> in the port's own format
(training/checkpoint.py, EMA parameters when the run kept them); orbax
checkpoints of the JAX package are not read, and nothing is downloaded.

Latency (skipped with --quality-only): the median over 5 samples of the
per-frame ms of --chain frames of the train-family frame, timed by CUDA
events (tools/_timing.py). The families are host numpy frames (seeds
2000+f, add_mc_noise(spp, seed=31*f)); the traced Monte-Carlo family
(skipped with --no-mc) comes from data/mc_tracer.py on the device, whose
draws are torch's, not threefry's: other samples of the same estimator.
Runs on the card unless --device cpu is given; the JAX tool's --cpu is
--device cpu here.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from deepdenoiser_tpu_torch import device as device_lib
from deepdenoiser_tpu_torch import weights_io
from deepdenoiser_tpu_torch.config import InferenceConfig
from deepdenoiser_tpu_torch.data import (mc_tracer, synthetic, synthetic_boxes,
                                         synthetic_holdout, synthetic_spheres)
from deepdenoiser_tpu_torch.inference import sequence
from deepdenoiser_tpu_torch.models import factory
from deepdenoiser_tpu_torch.models.factory import ModelConfig
from deepdenoiser_tpu_torch.ops import metrics
from deepdenoiser_tpu_torch.tools import _timing
from deepdenoiser_tpu_torch.tools.export_release_weights import checkpoint_params
from deepdenoiser_tpu_torch.tools.pretrain_flagship import MODELS, MODES, REPO_ROOT, WEIGHTS_DIR

CHECKPOINTS_DIR = REPO_ROOT / "checkpoints"
LATENCY_SAMPLES = 5
# 'train' = Fourier, 'voronoi' = in the training mix, 'holdout' = the
# untouched spheres family, 'holdout2' = the untouched boxes family
FAMILIES = (("train-family", synthetic.generate_clean_passes),
            ("voronoi", synthetic_holdout.generate_clean_passes),
            ("holdout", synthetic_spheres.generate_clean_passes),
            ("holdout2", synthetic_boxes.generate_clean_passes))

Frames = List[Tuple[Mapping[str, Any], Any]]  # (noisy passes, clean combined)


def load_model_params(name: str) -> Tuple[ModelConfig, Dict[str, Any], str]:
    """(ModelConfig, params, mode) for a zoo member; params is the Flax
    tree as numpy that the frame factories take."""
    mcfg = MODELS[name]
    mode = MODES[mcfg.out_channels]
    npz = WEIGHTS_DIR / f"{name.replace('-', '_')}_ema_f16.npz"
    if npz.exists():
        return mcfg, weights_io.load_release_params(npz), mode
    ckpt = CHECKPOINTS_DIR / name
    got = checkpoint_params(ckpt) if ckpt.is_dir() else None
    if got is not None:
        return mcfg, got[0], mode
    raise FileNotFoundError(f"no weights for {name!r} (looked at {npz} and {ckpt})")


def init_params(mcfg: ModelConfig, seed: int = 0) -> Dict[str, Any]:
    """Seeded random parameters as the Flax tree the frame factories take:
    factory.init_model drawing from a CPU torch.Generator seeded by `seed`
    (the JAX package's factory.init_params draws from a PRNGKey)."""
    model = factory.init_model(mcfg, torch.Generator().manual_seed(seed))
    return weights_io.params_from_state_dict(model.state_dict())


def family_frames(height: int, width: int, frames: int, spp: int) -> Dict[str, Frames]:
    """The four host families' (noisy, clean combined) frames, as numpy."""
    out = {}
    for fam, gen in FAMILIES:
        out[fam] = []
        for f in range(frames):
            clean = gen(height, width, seed=2000 + f)
            out[fam].append((synthetic.add_mc_noise(clean, spp=spp, seed=31 * f),
                             clean["combined"]))
    return out


def quality(pred, noisy, gt) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(PSNR, SSIM, noisy PSNR) of the tonemapped (H, W, 3) combined frames
    against `gt`: 0-d tensors on the device the frames are on."""
    tm = metrics.tonemap_for_metrics
    ref = tm(gt)[None]
    out = tm(pred)[None]
    return (metrics.psnr_per_image(out, ref)[0], metrics.ssim(out, ref)[0],
            metrics.psnr_per_image(tm(noisy)[None], ref)[0])


def to_device(frame: Mapping[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in frame.items()}


def on_device(frames: Frames, device: torch.device) -> Frames:
    """(noisy, clean combined) pairs as float32 tensors on `device`."""
    return [(to_device(n, device), torch.as_tensor(g, dtype=torch.float32, device=device))
            for n, g in frames]


def main(argv: List[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--models", nargs="+", default=["flagship", "flagship-hq", "tiramisu", "kpn"])
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--frames", type=int, default=2)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--chain", type=int, default=6, help="frames per timed latency sample")
    p.add_argument("--mc-gt-spp", type=int, default=1024,
                   help="GT sample count of the traced MC family (residual GT noise power = "
                        "spp_noisy/spp_gt below the noisy frame; 1024 vs 4 = -24 dB)")
    p.add_argument("--no-mc", action="store_true",
                   help="skip the traced Monte-Carlo family column (data/mc_tracer.py)")
    p.add_argument("--quality-only", action="store_true",
                   help="skip the latency samples (latency prints as null)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)
    dev = device_lib.resolve(args.device)

    h, w = args.height, args.width
    icfg = InferenceConfig(tile=0, compute_dtype="bfloat16")
    families: Dict[str, Frames] = family_frames(h, w, args.frames, args.spp)
    if not args.no_mc:
        # the noisy frame is a genuine spp-sample estimate (fireflies,
        # penumbra-correlated variance); GT = the same estimator at --mc-gt-spp
        families["mc"] = []
        for f in range(args.frames):
            clean = mc_tracer.generate_clean_passes(h, w, seed=2000 + f, spp=args.mc_gt_spp,
                                                    device=dev)
            noisy = mc_tracer.generate_noisy_passes(h, w, seed=2000 + f, spp=args.spp,
                                                    sample_seed=31 * f, device=dev)
            families["mc"].append((noisy, clean["combined"]))
            print(f"mc frame {f}: traced gt {args.mc_gt_spp} spp + noisy {args.spp} spp",
                  file=sys.stderr, flush=True)
    families = {fam: on_device(frames, dev) for fam, frames in families.items()}

    rows = []
    for name in args.models:
        try:
            mcfg, params, mode = load_model_params(name)
        except FileNotFoundError as e:
            print(f"skip {name}: {e}", file=sys.stderr)
            continue
        denoise, _ = sequence.make_mode_denoiser(mcfg, icfg, h, w, params, mode, device=dev)

        lat_ms = None
        if not args.quality_only:
            frame0 = families["train-family"][0][0]
            lat_ms = float(np.median(_timing.per_frame_ms(
                lambda: denoise(frame0), args.chain, LATENCY_SAMPLES, dev)))

        row: Dict[str, Any] = {"model": name, "mode": mode,
                               "latency_ms": round(lat_ms, 1) if lat_ms is not None else None}
        for fam, frames in families.items():
            gains, psnrs, ssims = [], [], []
            for noisy, gt in frames:
                pd, sd, pn = (float(x) for x in quality(denoise(noisy)["combined"],
                                                        noisy["combined"], gt))
                psnrs.append(pd)
                ssims.append(sd)
                gains.append(pd - pn)
            key = fam.replace("-family", "")
            row[f"{key}_psnr"] = round(float(np.mean(psnrs)), 2)
            row[f"{key}_gain_db"] = round(float(np.mean(gains)), 2)
            row[f"{key}_ssim"] = round(float(np.mean(ssims)), 4)
        rows.append(row)
        del denoise
        lat_str = f"{lat_ms:7.1f}" if lat_ms is not None else "    n/a"
        mc_str = (f"  mc {row['mc_psnr']:.2f} dB ({row['mc_gain_db']:+.2f})"
                  if "mc_psnr" in row else "")
        print(f"{name:12s} mode={mode:5s} {lat_str} ms  "
              f"train {row['train_psnr']:.2f} dB ({row['train_gain_db']:+.2f})  "
              f"holdout {row['holdout_psnr']:.2f} dB ({row['holdout_gain_db']:+.2f})  "
              f"holdout2 {row['holdout2_psnr']:.2f} dB ({row['holdout2_gain_db']:+.2f})"
              f"{mc_str}", flush=True)

    print(json.dumps({"zoo": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
