"""Seeded weights in the release format, for a configuration that has no
trained release file (the benchmark's frames driver loads `bench.weights`
from a file):

    python3 -m h100_bench.seeded --config unet-multiscale --seed <n> \\
        --gain <g> --bias-std <b> --out h100_bench/weights/<name>_seeded_f16.npz

The parameters are those the configuration's reference module lists
(`param_shapes(model)` of reference/<bench.reference>.py: the flat Flax
paths of the release format, "UNet_0/ConvStack_0/ConvBlock_0/Conv_0/kernel",
kernels HWIO), so a new architecture brings its shapes in its own module.
The recipe: those parameters in sorted path order, each drawn from one
numpy Generator (PCG64) seeded by --seed:
a kernel lecun-normal times `gain` (a normal cut at two standard
deviations and drawn again there, scaled to the standard deviation
gain / sqrt(fan in), fan in = kh * kw * in channels), a bias
normal(0, bias_std). Every conv is drawn, the 1x1 head included:
a zero head makes a residual model's output its noisy signal, and a
comparison with the reference then tests nothing. Stored as float16
under "params/<path>", compressed, as the program's
weights_io.save_release_params writes a release file. Plain numpy and
the reference module: nothing of the program is imported.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, Mapping

import numpy as np

from h100_bench import registry

HERE = Path(__file__).resolve().parent
CUT = 2.0
CUT_STD = 0.87962566103423978  # the standard deviation of N(0, 1) cut at +-2


def _cut_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """Standard normal draws, those beyond +-CUT drawn again."""
    z = rng.standard_normal(int(np.prod(shape)))
    bad = np.abs(z) > CUT
    while bad.any():
        z[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(z) > CUT
    return z.reshape(shape)


def draw(model: Mapping, seed: int, gain: float, bias_std: float, arch=None
         ) -> Dict[str, np.ndarray]:
    """The recipe's parameters, flat Flax paths -> float16 arrays, of the
    shapes that `arch` (the configuration's reference module; by default
    the one the model's fields name, registry.architecture) lists."""
    arch = arch or registry.architecture(model)
    rng = np.random.default_rng(seed)
    out = {}
    for path, shape in sorted(arch.param_shapes(model).items()):
        if path.endswith("/kernel"):
            fan_in = shape[0] * shape[1] * shape[2]
            v = _cut_normal(rng, shape) * (gain / np.sqrt(fan_in) / CUT_STD)
        else:
            v = rng.standard_normal(shape) * bias_std
        out[path] = v.astype(np.float16)
    return out


def save(path, flat: Mapping[str, np.ndarray]) -> None:
    """The release npz: "params/<path>" keys, float16, compressed."""
    np.savez_compressed(path, **{f"params/{k}": np.asarray(v, np.float16) for k, v in flat.items()})


def main(argv=None, root: Path = HERE) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True, help="a configuration name under configs/")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--gain", type=float, required=True)
    p.add_argument("--bias-std", type=float, required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    cfg = json.loads((root / "configs" / f"{args.config}.json").read_text())
    arch = registry.reference(cfg["bench"]["reference"], root)
    save(args.out, draw(cfg["model"], args.seed, args.gain, args.bias_std, arch))
    return 0


if __name__ == "__main__":
    sys.exit(main())
