"""4K tiling-ladder sweep: the whole frame against square tiles and tile
batches, flagship-hq, two frames each, through tools/bench_4k.py.

    python -m deepdenoiser_tpu_torch.tools.sweep_4k [--device cpu]

The port of tools/sweep_4k.sh, as a module: each of CONFIGS runs
`python -m deepdenoiser_tpu_torch.tools.bench_4k --model flagship-hq
--frames 2 <config>` in its own process, stopped after 600 s; each prints
its JSON line. Exits 1 when any config failed. Runs on the card unless
--device cpu is given (passed on to bench_4k).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from typing import List

from deepdenoiser_tpu_torch import device as device_lib
from deepdenoiser_tpu_torch.tools.pretrain_flagship import REPO_ROOT

CONFIGS = [
    ["--tile", "0", "--border", "32"],
    ["--tile", "1088", "--tile-batch", "0"],
    ["--tile", "1088", "--tile-batch", "2"],
    ["--tile", "1088", "--tile-batch", "4"],
    ["--tile", "736", "--tile-batch", "3"],
]
TIMEOUT_S = 600


def main(argv: List[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)
    device_lib.resolve(args.device)  # the card, or raise before any run starts
    device = ["--device", args.device] if args.device else []
    failed = []
    for cfg in CONFIGS:
        print(f"=== bench_4k {' '.join(cfg)} ===", flush=True)
        cmd = [sys.executable, "-m", "deepdenoiser_tpu_torch.tools.bench_4k",
               "--model", "flagship-hq", "--frames", "2", *cfg, *device]
        try:
            rc = subprocess.run(cmd, cwd=REPO_ROOT, timeout=TIMEOUT_S).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
        if rc != 0:
            print(f"FAILED ({rc}): {' '.join(cfg)}", flush=True)
            failed.append(cfg)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
