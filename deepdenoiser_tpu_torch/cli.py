"""Command line of the PyTorch port: the `denoise` and `eval` subcommands.

    deepdenoiser-torch denoise --preset kpn-hq --weights weights/kpn_hq_ema_f16.npz \\
        --frame frame_dir_or_multilayer.exr --out out.exr [--passes] [--device cpu]
    deepdenoiser-torch denoise --config experiment.json --weights ... --mode group ...
    deepdenoiser-torch eval --preset flagship-hq --weights weights/flagship_hq_ema_f16.npz \\
        --renders render_root

The port of deepdenoiser_tpu/cli.py's denoise and eval from release
weights, in group, joint and rgb mode. The experiment comes from --preset
or from a --config JSON (config.save's format, as either package writes
it); a JSON is also the way to settings no preset carries: infer.tile,
infer.tile_batch and infer.stitch for tiled frames,
infer.use_pallas_ingest for the fused ingest kernels, data.pass_scales.
`eval` prints the sequence harness's JSON report (per-frame latency, PSNR
and SSIM against the ground truth of a render root). Both run on the card
("cuda") unless --device says otherwise and fail when there is no card.
--checkpoint (training checkpoints) comes with the training slice and
exits 2; the other subcommands (train, prepare-data, synth-data) are not
ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path


def _load_frame(path: Path):
    from deepdenoiser_tpu_torch.data import exr

    if path.is_dir():
        return exr.load_frame_dir(path, strict=False)
    return exr.load_multilayer_exr(path)


def _load_config(args):
    from deepdenoiser_tpu_torch import config as config_lib

    cfg = config_lib.load(args.config) if args.config else config_lib.PRESETS[args.preset]
    return config_lib.validate_channels(cfg)


def cmd_denoise(args) -> int:
    from deepdenoiser_tpu_torch import config as config_lib
    from deepdenoiser_tpu_torch import weights_io
    from deepdenoiser_tpu_torch.data import exr
    from deepdenoiser_tpu_torch.inference import pipeline

    cfg = _load_config(args)
    mcfg = cfg.model
    mode = args.mode or cfg.data.mode
    if args.mode and args.mode != cfg.data.mode:
        # surface the mismatch up front instead of a deep shape error
        try:
            want = config_lib.input_channels(dataclasses.replace(cfg.data, mode=args.mode))
        except ValueError as e:
            # e.g. a use_flags config overridden to group or rgb mode
            print(f"error: --mode {args.mode} is incompatible with this config: {e}",
                  file=sys.stderr)
            return 2
        if mcfg.in_channels != want:
            print(f"error: --mode {args.mode} needs {want} input channels but the "
                  f"config's model has {mcfg.in_channels} "
                  f"(mode={cfg.data.mode!r})", file=sys.stderr)
            return 2
    frame = _load_frame(Path(args.frame))
    h, w = next(iter(frame.values())).shape[:2]
    params = weights_io.load_release_params(args.weights)
    scales = dict(cfg.data.pass_scales) or None
    if mode == "group":
        denoise, _ = pipeline.make_group_frame_denoiser(
            mcfg, cfg.infer, h, w, params, device=args.device, scales=scales,
        )
    elif mode == "joint":
        denoise, _ = pipeline.make_joint_frame_denoiser(
            mcfg, cfg.infer, h, w, params,
            groups=tuple(cfg.data.groups), device=args.device,
            use_flags=cfg.data.use_flags, scales=scales,
        )
    else:
        denoise, _ = pipeline.make_rgb_frame_denoiser(
            mcfg, cfg.infer, h, w, params, device=args.device, scales=scales,
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


def cmd_eval(args) -> int:
    """Full-frame PSNR/SSIM against ground truth over a render root."""
    from deepdenoiser_tpu_torch import weights_io
    from deepdenoiser_tpu_torch.inference import sequence

    cfg = _load_config(args)
    params = weights_io.load_release_params(args.weights)
    report = sequence.evaluate_render_root(
        cfg.model, cfg.infer, params, args.renders, mode=cfg.data.mode,
        scales=dict(cfg.data.pass_scales) or None,
        groups=tuple(cfg.data.groups), use_flags=cfg.data.use_flags,
        device=args.device,
    )
    print(json.dumps(report, indent=2))
    return 0


def build_parser() -> argparse.ArgumentParser:
    from deepdenoiser_tpu_torch import config as config_lib

    p = argparse.ArgumentParser(
        prog="deepdenoiser-torch",
        description="Monte-Carlo render denoiser, PyTorch/CUDA port",
    )
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        src = sp.add_mutually_exclusive_group(required=True)
        src.add_argument("--preset", choices=sorted(config_lib.PRESETS))
        src.add_argument("--config", help="experiment JSON (config.save's format)")
        sp.add_argument("--weights", help="release npz weight file (weights/*.npz)")
        sp.add_argument("--checkpoint",
                        help="training checkpoint directory (comes with the training slice)")
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; the CPU only when asked)")

    sp = sub.add_parser("denoise", help="denoise a full frame")
    common(sp)
    sp.add_argument("--frame", required=True,
                    help="frame EXR directory or multilayer EXR file")
    sp.add_argument("--out", required=True)
    sp.add_argument("--mode", choices=["group", "joint", "rgb"],
                    help="must agree with the config's data mode")
    sp.add_argument("--passes", action="store_true",
                    help="write all denoised passes, not just combined")
    sp.set_defaults(fn=cmd_denoise)

    sp = sub.add_parser("eval", help="PSNR/SSIM + latency over a render root")
    common(sp)
    sp.add_argument("--renders", required=True,
                    help="render root: <frame>/ground_truth and <frame>/spp<N>_seed<K> dirs")
    sp.set_defaults(fn=cmd_eval)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.checkpoint:
        print("error: --checkpoint needs the training slice of the port, which is not "
              "here yet; pass --weights with a release npz file", file=sys.stderr)
        return 2
    if not args.weights:
        print("error: --weights is required", file=sys.stderr)
        return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
