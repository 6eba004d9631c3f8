"""Command line of the PyTorch port: the `denoise` subcommand.

    deepdenoiser-torch denoise --preset kpn-hq --weights weights/kpn_hq_ema_f16.npz \\
        --frame frame_dir_or_multilayer.exr --out out.exr [--passes] [--device cpu]

The port of deepdenoiser_tpu/cli.py's denoise, joint mode, release
weights. It runs on the card ("cuda") unless --device says otherwise and
fails when there is no card. The other subcommands (train, eval,
prepare-data, synth-data), --config and --checkpoint are not ported yet.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _load_frame(path: Path):
    from deepdenoiser_tpu_torch.data import exr

    if path.is_dir():
        return exr.load_frame_dir(path, strict=False)
    return exr.load_multilayer_exr(path)


def cmd_denoise(args) -> int:
    from deepdenoiser_tpu_torch import config as config_lib
    from deepdenoiser_tpu_torch import weights_io
    from deepdenoiser_tpu_torch.data import exr
    from deepdenoiser_tpu_torch.inference import pipeline

    cfg = config_lib.PRESETS[args.preset]
    if args.mode and args.mode != cfg.data.mode:
        print(f"error: --mode {args.mode} does not match preset {args.preset!r} "
              f"(mode={cfg.data.mode!r})", file=sys.stderr)
        return 2
    cfg = config_lib.validate_channels(cfg)
    frame = _load_frame(Path(args.frame))
    h, w = next(iter(frame.values())).shape[:2]
    params = weights_io.load_release_params(args.weights)
    denoise, _ = pipeline.make_joint_frame_denoiser(
        cfg.model, cfg.infer, h, w, params,
        groups=tuple(cfg.data.groups), device=args.device,
        use_flags=cfg.data.use_flags, scales=dict(cfg.data.pass_scales) or None,
    )
    out = denoise(frame)
    out_np = {k: v.float().cpu().numpy() for k, v in out.items()}

    out_path = Path(args.out)
    if args.passes:
        exr.save_frame_dir(out_path, out_np)
        print(f"wrote denoised pass directory {out_path}")
    else:
        exr.write_exr(out_path, out_np["combined"])
        print(f"wrote {out_path}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    from deepdenoiser_tpu_torch import config as config_lib

    p = argparse.ArgumentParser(
        prog="deepdenoiser-torch",
        description="Monte-Carlo render denoiser, PyTorch/CUDA port",
    )
    sub = p.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("denoise", help="denoise a full frame")
    sp.add_argument("--preset", required=True, choices=sorted(config_lib.PRESETS))
    sp.add_argument("--weights", required=True,
                    help="release npz weight file (weights/*.npz)")
    sp.add_argument("--frame", required=True,
                    help="frame EXR directory or multilayer EXR file")
    sp.add_argument("--out", required=True)
    sp.add_argument("--mode", choices=["joint"])
    sp.add_argument("--passes", action="store_true",
                    help="write all denoised passes, not just combined")
    sp.add_argument("--device", default="cuda",
                    help="torch device (default cuda; the CPU only when asked)")
    sp.set_defaults(fn=cmd_denoise)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
