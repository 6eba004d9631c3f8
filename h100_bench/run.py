"""Run one benchmark cell once on the card and print its result line.

    python3 -m h100_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (imports, the program's kernel build
into build/torch_kernels/ on a checkout's first run, weights, inputs made
on the card from --seed, warm-up) is timed as setup_s; then the window
runs for --seconds; then the plain reference checks what the window
produced. --trace 0 prints the cell's end-to-end metrics, --trace 1 its
per-layer metrics from the profiler's device trace. The last line of
standard output is one JSON object; the numbers compared with the
reference, each beside its limit, are the last lines of standard error.

Exits non-zero, with no result, when there is no card or fewer cards than
the cell asks for, when the program cannot be imported, and when JAX or
the JAX package is loaded in this process once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "deepdenoiser_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    jaxlib's, flax's or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from h100_bench import harness, registry

    bench = registry.load()
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"h100_bench: the cell needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), device, T0)
    found = forbidden_modules()
    if found:
        print(f"h100_bench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    harness.print_checks(result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
