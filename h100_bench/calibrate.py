"""Readings that the limits of `correct` are set from, on the card at a
cell's own size, in one process for many seeds:

    python3 -m h100_bench.calibrate --workload <name> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--seconds 2]

For each seed: the program's readings (a short window at the cell's own
load, the same sampled outputs and the same comparison as a run); for each
control seed besides, the control's: the plain reference with every conv
operand rounded to float8, put in the program's place and compared with
the float32 reference by the same numbers; for a training cell also the
fault of half the batch left out (the reference trained on the first half
of each batch, the mean taken over it), and of each the leaf readings that
no limit compares (grad_gap, the worst leaves). One JSON line a seed. The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from h100_bench import registry, trace


def readings(cell: registry.Cell, seed: int, seconds: float, control: bool, device) -> dict:
    drv = registry.driver(cell.traffic["driver"], cell.root)
    session = drv.Session(cell, seed, device)
    session.window(seconds, trace.Spans())
    session.release()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"seed": seed}
    if cell.traffic["driver"] == "frames":
        ref = session.references()
        out["program"] = session.compare([(f, o) for _, f, o in session.held], ref)
        if control:
            out["control_f8"] = session.compare(sorted(session.references(f8=True).items()), ref)
        return out
    ref = session.reference()
    out["program"] = session.compare(session.readings(), ref)
    out["program_leaves"] = drv.leaves(session.readings(), ref)
    if control:
        f8 = session.reference(f8=True)
        out["control_f8"] = session.compare(f8, ref)
        out["control_leaves"] = drv.leaves(f8, ref)
        full = session.batches
        session.batches = [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in full]
        half = session.reference()
        session.batches = full
        out["fault_half_batch"] = session.compare(half, ref)
        out["fault_half_batch_leaves"] = drv.leaves(half, ref)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = registry.load().cell(args.workload)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for s in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = readings(cell, s, args.seconds, s in control, torch.device("cuda", 0))
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
