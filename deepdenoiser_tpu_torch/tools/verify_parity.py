"""TF-checkpoint parity of the port against the JAX package's frozen
goldens (tests/goldens/tf_compat/<fam>/).

    python -m deepdenoiser_tpu_torch.tools.verify_parity [--device cpu]
                                    # check all four families, report each
    python -m deepdenoiser_tpu_torch.tools.verify_parity --ckpt PREFIX --family unet
                                    # import an external TF checkpoint
                                    # through the name map into the model

The port of tools/verify_parity.py, without --make: the goldens are the
JAX package's artifacts and are not rewritten here. Runs on the card
unless --device cpu is given. Exit code 0 = every checked family within
compat/goldens.ATOL.
"""

from __future__ import annotations

import argparse
import sys
from typing import List

from deepdenoiser_tpu_torch import device as device_lib
from deepdenoiser_tpu_torch import weights_io
from deepdenoiser_tpu_torch.compat import goldens
from deepdenoiser_tpu_torch.compat import tf_checkpoint as tfc
from deepdenoiser_tpu_torch.models import factory


def main(argv: List[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", default=None,
                   help="external TF checkpoint prefix to import instead")
    p.add_argument("--family", default=None, choices=sorted(goldens.GOLDEN_CFGS))
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)
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

    rc = 0
    for fam in [args.family] if args.family else sorted(goldens.GOLDEN_CFGS):
        try:
            dev_abs = goldens.check(fam, device=dev)
            print(f"{fam}: OK (max deviation {dev_abs:.2e})")
        except Exception as e:  # noqa: BLE001 — report every family
            print(f"{fam}: FAIL — {e}")
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
