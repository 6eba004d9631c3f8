"""Command line of the PyTorch port: train, prepare-data, synth-data,
denoise and eval, with the JAX package's flags.

    deepdenoiser-torch synth-data   --out renders/ [--frames 4 --size 128]
    deepdenoiser-torch prepare-data --renders renders/ --out shards/ [--config c.json]
    deepdenoiser-torch train        --config c.json --workdir runs/x --shards shards/ [--steps N]
    python -m torch.distributed.run --nproc_per_node N -m deepdenoiser_tpu_torch.cli train ...
    deepdenoiser-torch denoise      --config runs/x/config.json --checkpoint runs/x/checkpoints \\
                                    --ema --frame frame_dir_or_multilayer.exr --out out.exr
    deepdenoiser-torch denoise      --preset kpn-hq --weights weights/kpn_hq_ema_f16.npz \\
                                    --frame ... --out out.exr [--passes] [--mode joint]
    deepdenoiser-torch eval         --preset flagship-hq --weights ... --renders render_root

The port of deepdenoiser_tpu/cli.py. The experiment comes from --preset
or from a --config JSON (config.save's format, as either package writes
it; `train` saves the one it ran as <workdir>/config.json); a JSON is also
the way to settings no preset carries (infer.tile, infer.tile_batch,
infer.stitch, infer.use_pallas_ingest, data.pass_scales, the train
section). `denoise` and `eval` take release weights (--weights, which win)
or the newest training checkpoint under --checkpoint (the port's format,
training/checkpoint.py; with none there they warn and run random
weights, as the JAX package does). `eval` prints the sequence harness's
JSON report. `train` under a launcher trains data-parallel on every rank
(training/loop.fit); band-parallel frames are reached through a --config
with infer.spatial_shard and the library's `mesh` argument, as in the JAX
package, whose command line builds no mesh. `train`, `denoise` and `eval`
run on the card ("cuda") unless --device says otherwise, and fail when
there is no card;
`synth-data` and `prepare-data` run on the host and take no --device.
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

    if args.config:
        cfg = config_lib.load(args.config)
    elif args.preset:
        cfg = config_lib.PRESETS[args.preset]
    else:
        cfg = config_lib.ExperimentConfig()
    return config_lib.validate_channels(cfg)


def _load_params(args, cfg, what: str):
    """The Flax tree the frame factories take: the release file, or the
    newest checkpoint's parameters (its EMA with --ema)."""
    from deepdenoiser_tpu_torch import weights_io

    if args.weights:
        return weights_io.load_release_params(args.weights)
    from deepdenoiser_tpu_torch.training import train as train_lib
    from deepdenoiser_tpu_torch.training.checkpoint import CheckpointManager

    state = train_lib.create_state(cfg.model, cfg.train, seed=0, device=args.device)
    mgr = CheckpointManager(args.checkpoint)
    restored = mgr.restore_latest(state)
    mgr.close()
    if restored is None:
        print(f"WARNING: no checkpoint under {args.checkpoint}; {what} with random weights",
              file=sys.stderr)
        sd = state.model.state_dict()
    else:
        st = restored[0]
        sd = st.ema_params if (args.ema and st.ema_params is not None) else st.model.state_dict()
    return weights_io.params_from_state_dict(sd)


def cmd_prepare_data(args) -> int:
    from deepdenoiser_tpu_torch.data import prepare

    cfg = _load_config(args)
    metas = prepare.prepare_dataset(args.renders, args.out, cfg.data)
    for split, meta in metas.items():
        print(f"{split}: {meta.n_examples} examples, {len(meta.shard_sizes)} shards")
    return 0


def cmd_synth_data(args) -> int:
    from deepdenoiser_tpu_torch.data import prepare

    prepare.generate_synthetic_render_root(
        args.out, n_frames=args.frames, height=args.size, width=args.size,
        spps=tuple(args.spp), n_seeds=args.seeds, seed=args.seed,
    )
    print(f"wrote {args.frames} synthetic frames under {args.out}")
    return 0


def cmd_train(args) -> int:
    """One process trains alone; under `python -m torch.distributed.run
    --nproc_per_node N` each is a data-parallel rank (parallel/dist.py)."""
    from deepdenoiser_tpu_torch.parallel import dist
    from deepdenoiser_tpu_torch.training import loop

    cfg = _load_config(args)
    if args.steps:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, steps=args.steps))
    group = dist.init_from_env(args.device)
    try:
        loop.fit(cfg, args.workdir, shard_dir=args.shards, device=args.device, group=group)
    finally:
        dist.shutdown(group)
    return 0


def cmd_denoise(args) -> int:
    from deepdenoiser_tpu_torch import config as config_lib
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
    params = _load_params(args, cfg, "denoising")
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
    from deepdenoiser_tpu_torch.inference import sequence

    cfg = _load_config(args)
    params = _load_params(args, cfg, "evaluating")
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

    def experiment(sp, required: bool):
        src = sp.add_mutually_exclusive_group(required=required)
        src.add_argument("--preset", choices=sorted(config_lib.PRESETS))
        src.add_argument("--config", help="experiment JSON (config.save's format)")

    def device(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; the CPU only when asked)")

    def weight_source(sp):
        sp.add_argument("--checkpoint", help="training checkpoint directory (<workdir>/checkpoints)")
        sp.add_argument("--weights", help="release npz weight file (weights/*.npz), already "
                                          "EMA; overrides --checkpoint")

    sp = sub.add_parser("prepare-data", help="EXR render root -> training shards")
    experiment(sp, required=False)
    sp.add_argument("--renders", required=True)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_prepare_data)

    sp = sub.add_parser("synth-data", help="generate a synthetic (Fourier family) render root")
    sp.add_argument("--out", required=True)
    sp.add_argument("--frames", type=int, default=4)
    sp.add_argument("--size", type=int, default=128)
    sp.add_argument("--spp", type=int, nargs="+", default=[4, 16])
    sp.add_argument("--seeds", type=int, default=1)
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=cmd_synth_data)

    sp = sub.add_parser("train", help="train (auto-resumes from workdir)")
    experiment(sp, required=False)
    sp.add_argument("--workdir", required=True)
    sp.add_argument("--shards", required=True)
    sp.add_argument("--steps", type=int)
    device(sp)
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("denoise", help="denoise a full frame")
    experiment(sp, required=True)
    weight_source(sp)
    device(sp)
    sp.add_argument("--frame", required=True,
                    help="frame EXR directory or multilayer EXR file")
    sp.add_argument("--out", required=True)
    sp.add_argument("--mode", choices=["group", "joint", "rgb"],
                    help="must agree with the config's data mode")
    sp.add_argument("--passes", action="store_true",
                    help="write all denoised passes, not just combined")
    sp.add_argument("--ema", action="store_true",
                    help="use the checkpoint's EMA parameters (release files are already EMA)")
    sp.set_defaults(fn=cmd_denoise)

    sp = sub.add_parser("eval", help="PSNR/SSIM + latency over a render root")
    experiment(sp, required=True)
    weight_source(sp)
    device(sp)
    sp.add_argument("--ema", action=argparse.BooleanOptionalAction, default=True,
                    help="evaluate the checkpoint's EMA parameters (default; --no-ema for "
                         "the raw ones)")
    sp.add_argument("--renders", required=True,
                    help="render root: <frame>/ground_truth and <frame>/spp<N>_seed<K> dirs")
    sp.set_defaults(fn=cmd_eval)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.fn in (cmd_denoise, cmd_eval) and not args.checkpoint and not args.weights:
        print("error: one of --checkpoint or --weights is required", file=sys.stderr)
        return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
