"""Where a frame's FLOPs, bytes and time go: the frame split into stages,
and the ops of one frame by output bytes.

    python -m deepdenoiser_tpu_torch.tools.traffic_breakdown [--model flagship-hq] \\
        [--height 1080 --width 1920] [--border -1] [--top 25] \\
        [--time [--chain 8 --samples 5]] [--out build/traffic_breakdown.txt] [--device cpu]

The port of tools/traffic_breakdown.py. The frame is bisected as the JAX
tool bisects it: encode -> net (the tile grid of inference/tiled.py over
the model: the reflect pad, the network, the crop) -> decode+recompose ->
FULL. Each stage's GFLOP and GB come from tools/roofline.count_frame
(counted from the shapes, each input byte read once and each output byte
written once), so the stages sum to FULL exactly.

--time runs each stage and FULL on the device, on inputs already there,
and prints the median over --samples samples of the per-call ms of
--chain calls, timed by CUDA events (tools/_timing.py), with the sum of
the stages beside FULL.

The op table takes the place of the JAX tool's table of optimized HLO: one
FULL frame runs under a TorchDispatchMode that records every aten op's
output bytes (views and allocations write nothing and are left out),
grouped by op, and the --top single ops. The KPN filter apply K1 is
launched through ctypes, which no dispatch mode sees, so it has a row of
its own, `kpn_apply`, with its launches from its wrapper's counter
(ops/kpn_apply.launches) and the bytes count_frame gives it. The report
is also written to --out ('' writes none). Runs on the card unless
--device cpu is given; the TPU lock of the JAX tool has no counterpart.
"""

from __future__ import annotations

import argparse
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from deepdenoiser_tpu_torch.tools.roofline import Row

REPO_ROOT = Path(__file__).resolve().parents[2]
STAGES = (("encode", ("encode",)), ("net", ("pad", "model", "crop")),
          ("decode+recompose", ("decode",)))


def stage_table(rows: List[Row]) -> List[tuple]:
    """[(stage, flops, bytes)] for the three stages and FULL."""
    out = []
    for name, parts in STAGES:
        sel = [r for r in rows if r.stage in parts]
        out.append((name, sum(r.flops for r in sel), sum(r.bytes for r in sel)))
    out.append(("FULL pipeline", sum(r.flops for r in rows), sum(r.bytes for r in rows)))
    return out


def _writes(func) -> bool:
    """False for an op whose output is a view of an input (no bytes
    written) or a fresh allocation that nothing has written yet."""
    if func.__name__.startswith(("empty", "new_empty")):
        return False
    returns = func._schema.returns
    alias = returns[0].alias_info if returns else None
    return alias is None or alias.is_write


class OpBytes(TorchDispatchMode):
    """Records every aten op's output bytes: by op (bytes, count) and each
    call (bytes, op, shape)."""

    def __init__(self):
        super().__init__()
        self.by_op: Dict[str, List[int]] = defaultdict(lambda: [0, 0])
        self.calls: List[tuple] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _writes(func):
            tensors = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            nbytes = sum(t.numel() * t.element_size() for t in tensors)
            name = str(func.overloadpacket)
            self.by_op[name][0] += nbytes
            self.by_op[name][1] += 1
            shape = tuple(tensors[0].shape) if tensors else ()
            self.calls.append((nbytes, str(func), shape))
        return out


def op_table(run, k1_rows: List[Row]) -> tuple:
    """One call of run() under OpBytes. Returns ({op: [bytes, count]}, the
    calls sorted by bytes); K1's row `kpn_apply` holds its launches during
    the call and the bytes its launches write (from `k1_rows`)."""
    from deepdenoiser_tpu_torch.ops import kpn_apply

    before = kpn_apply.launches
    with OpBytes() as rec:
        run()
    launches = kpn_apply.launches - before
    by_op = dict(rec.by_op)
    if launches:
        per = sum(r.bytes_written for r in k1_rows) / max(sum(r.calls for r in k1_rows), 1)
        by_op["kpn_apply"] = [int(per * launches), launches]
    return by_op, sorted(rec.calls, key=lambda c: -c[0])


def main(argv: List[str] | None = None) -> int:
    import numpy as np

    from deepdenoiser_tpu_torch import device as device_lib
    from deepdenoiser_tpu_torch import passes, transforms
    from deepdenoiser_tpu_torch.config import InferenceConfig
    from deepdenoiser_tpu_torch.data import synthetic
    from deepdenoiser_tpu_torch.inference import pipeline
    from deepdenoiser_tpu_torch.tools import _timing, eval_zoo, roofline
    from deepdenoiser_tpu_torch.tools.pretrain_flagship import MODELS

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="flagship-hq", choices=sorted(MODELS))
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--border", type=int, default=-1)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--time", action="store_true",
                   help="run each stage on the device and report its ms (CUDA events)")
    p.add_argument("--chain", type=int, default=8)
    p.add_argument("--samples", type=int, default=5)
    p.add_argument("--out", default=str(REPO_ROOT / "build" / "traffic_breakdown.txt"),
                   help="also write the report to this file; '' writes none")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)
    dev = device_lib.resolve(args.device)
    lines: List[str] = []

    def say(s: str = "") -> None:
        print(s, flush=True)
        lines.append(s)

    mcfg = MODELS[args.model]
    if mcfg.out_channels != 24:
        raise SystemExit(f"--model {args.model}: the stages are the joint pipeline's; pick a "
                         "joint-mode (24-channel) model")
    h, w = args.height, args.width
    icfg = InferenceConfig(tile=0, border=args.border, compute_dtype="bfloat16")
    rows = roofline.count_frame(mcfg, icfg, h, w)
    try:
        mcfg, params, _ = eval_zoo.load_model_params(args.model)
    except FileNotFoundError:
        params = eval_zoo.init_params(mcfg)
    denoise, grid = pipeline.make_joint_frame_denoiser(mcfg, icfg, h, w, params, device=dev)
    card = _timing.card_info(dev)
    say(f"{args.model} {w}x{h}: grid {grid.net_h}x{grid.net_w} | {card['device']}, "
        f"power limit {card['power_limit_w']} W")
    noisy = synthetic.add_mc_noise(synthetic.generate_clean_passes(h, w, seed=0), spp=4, seed=1)
    frame = eval_zoo.to_device(noisy, dev)

    def encode(pd):
        return transforms.encode_joint_inputs(pd)

    def decode(d, pd):
        out = dict(transforms.decode_joint_outputs(d, pd))
        for g in passes.LIGHT_GROUPS:
            out[passes.group_passes(g)[2]] = pd[passes.group_passes(g)[2]]
        for extra in passes.COMPOSITE_EXTRA + ("alpha",):
            if extra in pd:
                out[extra] = pd[extra]
        return transforms.recompose(out)

    say(f"{'stage':<18} {'GFLOP':>9} {'GB':>8}")
    for name, f, b in stage_table(rows):
        say(f"{name:<18} {f / 1e9:9.1f} {b / 1e9:8.2f}")

    with torch.inference_mode():
        enc = encode(frame)
        dec = denoise.frame_fn(enc)
        if args.time:
            def timed(fn, label):
                ms = float(np.median(_timing.per_frame_ms(fn, args.chain, args.samples, dev)))
                say(f"  {label:<18} {ms:8.2f} ms")
                return ms

            say(f"\nstage timings (CUDA events, median of {args.samples}x{args.chain}):"
                if dev.type == "cuda" else "\nstage timings (host clock on the CPU):")
            ms_e = timed(lambda: encode(frame), "encode")
            ms_n = timed(lambda: denoise.frame_fn(enc), "net")
            ms_d = timed(lambda: decode(dec, frame), "decode+recompose")
            ms_f = timed(lambda: denoise(frame), "FULL pipeline")
            say(f"  {'sum of stages':<18} {ms_e + ms_n + ms_d:8.2f} ms (FULL {ms_f:.2f})")
        k1_rows = [r for r in rows if r.kind == "kpn_apply"]
        by_op, calls = op_table(lambda: denoise(frame), k1_rows)

    say("\noutput-buffer bytes by op (one FULL frame):")
    for op, (b, n) in sorted(by_op.items(), key=lambda kv: -kv[1][0])[:20]:
        say(f"  {op:<34} {b / 1e9:8.3f} GB  x{n}")
    say(f"\ntop {args.top} single ops by output bytes:")
    for b, op, shape in calls[:args.top]:
        say(f"  {b / 1e9:7.3f} GB  {op} -> {shape}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
        print(f"[report written to {args.out}]", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
