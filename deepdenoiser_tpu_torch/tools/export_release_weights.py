"""Export compact release weights from a training checkpoint of the port.

    python -m deepdenoiser_tpu_torch.tools.export_release_weights \\
        [--ckpt checkpoints/flagship] [--out weights/flagship_ema_f16.npz] \\
        [--model flagship]

The port of tools/export_release_weights.py. Restores the newest
checkpoint under --ckpt (training/checkpoint.CheckpointManager), takes the
EMA parameters (the raw ones when the run kept no EMA), checks that they
fit --model (tools/pretrain_flagship.MODELS), and writes them as float16 in
the flat npz of the JAX package's release files (weights_io
.save_release_params), which both packages load with --weights. Weight
surgery on the host: nothing here runs on the card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List

from deepdenoiser_tpu_torch import weights_io
from deepdenoiser_tpu_torch.models import factory
from deepdenoiser_tpu_torch.tools.pretrain_flagship import MODELS
from deepdenoiser_tpu_torch.training.checkpoint import CheckpointManager


def main(argv: List[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", default="checkpoints/flagship")
    p.add_argument("--out", default="weights/flagship_ema_f16.npz")
    p.add_argument("--model", default="flagship", choices=sorted(MODELS))
    args = p.parse_args(argv)

    got = CheckpointManager(args.ckpt).read_latest(map_location="cpu") \
        if Path(args.ckpt).is_dir() else None
    if got is None:
        print(f"no checkpoint under {args.ckpt}", file=sys.stderr)
        return 1
    state, extra = got
    chosen = state["ema_params"] if state["ema_params"] is not None else state["params"]
    params = weights_io.params_from_state_dict(chosen)
    weights_io.load_into(factory.build_model(MODELS[args.model]), params)  # fits --model
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    weights_io.save_release_params(args.out, params)
    size = Path(args.out).stat().st_size / 1e6
    n = sum(v.size for v in weights_io.flatten(params).values())
    print(f"wrote {args.out} ({size:.1f} MB, step {int(state['step'])}, {n / 1e6:.2f}M params)")
    if extra:
        print(f"checkpoint extra: {extra}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
