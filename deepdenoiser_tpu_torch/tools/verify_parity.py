"""TF-checkpoint parity of the port against the JAX package's frozen
goldens (tests/goldens/tf_compat/<fam>/).

    python -m deepdenoiser_tpu_torch.tools.verify_parity [--device cpu]
                                    # check all four families, report each
    python -m deepdenoiser_tpu_torch.tools.verify_parity --make [--out DIR]
                                    # make the port's goldens of --family
                                    # or of all four, under DIR/<fam>
    python -m deepdenoiser_tpu_torch.tools.verify_parity --ckpt PREFIX --family unet
                                    # import an external TF checkpoint
                                    # through the name map into the model

The port of tools/verify_parity.py. --make writes what compat/goldens.make
writes; the JAX package's `goldens.check(fam, indir=DIR)` and the port's
read it back. --out is the one flag the JAX tool lacks: that tool writes
its goldens into tests/goldens/tf_compat, whose committed files the port
never rewrites, so --make writes under --out (default
build/goldens/tf_compat in the repository) and refuses any --out inside
tests/goldens. Runs on the card unless --device cpu is given. Exit code 0
= every checked family within compat/goldens.ATOL.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List

from deepdenoiser_tpu_torch import device as device_lib
from deepdenoiser_tpu_torch import weights_io
from deepdenoiser_tpu_torch.compat import goldens
from deepdenoiser_tpu_torch.compat import tf_checkpoint as tfc
from deepdenoiser_tpu_torch.models import factory


DEFAULT_OUT = goldens.golden_dir().parents[2] / "build" / "goldens" / "tf_compat"


def main(argv: List[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--make", action="store_true",
                   help="make the port's goldens under --out (the committed ones stay)")
    p.add_argument("--out", type=Path, default=None,
                   help="where --make writes, one directory per family "
                        "(default: build/goldens/tf_compat; never inside tests/goldens)")
    p.add_argument("--ckpt", default=None,
                   help="external TF checkpoint prefix to import instead")
    p.add_argument("--family", default=None, choices=sorted(goldens.GOLDEN_CFGS))
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)
    if args.make and args.ckpt:
        p.error("--make makes the goldens of the zoo's families; it takes no --ckpt")
    if args.out is not None and not args.make:
        p.error("--out is where --make writes; it needs --make")
    if args.make and args.out is None:
        args.out = DEFAULT_OUT
    if args.make and args.out.resolve().is_relative_to(goldens.golden_dir().parent.resolve()):
        p.error(f"--out {args.out} lies inside {goldens.golden_dir().parent}: the committed "
                "goldens are never rewritten; choose another directory")
    dev = device_lib.resolve(args.device)

    if args.ckpt:
        if not args.family:
            p.error("--ckpt needs --family for the architecture")
        cfg = goldens.GOLDEN_CFGS[args.family]
        params = tfc.import_checkpoint(args.ckpt, cfg)
        weights_io.load_into(factory.build_model(cfg).to(dev), params)
        n = len(weights_io.flatten(params["params"]))
        print(f"{args.family}: imported {n} variables from {args.ckpt} OK")
        return 0

    fams = [args.family] if args.family else sorted(goldens.GOLDEN_CFGS)
    if args.make:
        for fam in fams:
            goldens.make(fam, args.out / fam, device=dev)
            print(f"{fam}: goldens written to {args.out / fam}")
        return 0

    rc = 0
    for fam in fams:
        try:
            dev_abs = goldens.check(fam, device=dev)
            print(f"{fam}: OK (max deviation {dev_abs:.2e})")
        except Exception as e:  # noqa: BLE001 — report every family
            print(f"{fam}: FAIL — {e}")
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
