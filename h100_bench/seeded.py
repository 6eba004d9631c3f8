"""Seeded weights in the release format, for a configuration that has no
trained release file (the benchmark's frames driver loads `bench.weights`
from a file):

    python3 -m h100_bench.seeded --config unet-multiscale --seed <n> \\
        --gain <g> --bias-std <b> --out h100_bench/weights/<name>_seeded_f16.npz

The recipe: the UNet's parameters (the flat Flax paths of the release
format, "UNet_0/ConvStack_0/ConvBlock_0/Conv_0/kernel", HWIO) in sorted
path order, each drawn from one numpy Generator (PCG64) seeded by --seed:
a kernel lecun-normal times `gain` (a normal cut at two standard
deviations and drawn again there, scaled to the standard deviation
gain / sqrt(fan in), fan in = kh * kw * in channels), a bias
normal(0, bias_std). Every conv is drawn, the UNet's 1x1 head included:
a zero head makes a residual model's output its noisy signal, and a
comparison with the reference then tests nothing. Stored as float16
under "params/<path>", compressed, as the program's
weights_io.save_release_params writes a release file. Plain numpy:
nothing of the program is imported.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, Mapping, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
CUT = 2.0
CUT_STD = 0.87962566103423978  # the standard deviation of N(0, 1) cut at +-2


def unet_shapes(model: Mapping) -> Dict[str, Tuple[int, ...]]:
    """Flat Flax path -> shape of every parameter of the model's UNet (a
    residual or multi-scale model: no KPN head), kernels HWIO."""
    if model["backbone"] != "unet" or model["kernel_prediction"] or model["stem_stride"] != 1:
        raise ValueError("seeded weights cover UNet models with a stride-1 stem and no KPN head")
    depth, n_conv = model["depth"], model["convs_per_level"]
    widths = [min(int(model["base_width"] * 2.0 ** level), 512) for level in range(depth + 1)]
    convs: Dict[str, Tuple[int, int, int]] = {}

    def stack(i, cin, width):
        for j in range(n_conv):
            convs[f"UNet_0/ConvStack_{i}/ConvBlock_{j}/Conv_0"] = (3, cin if j == 0 else width, width)

    stack(0, model["in_channels"], widths[0])
    for level in range(1, depth + 1):
        convs[f"UNet_0/DownSample_{level - 1}/ConvBlock_0/Conv_0"] = (3, widths[level - 1],
                                                                       widths[level])
        stack(level, widths[level], widths[level])
    for i, level in enumerate(range(depth - 1, -1, -1)):
        convs[f"UNet_0/UpSample_{i}/ConvBlock_0/Conv_0"] = (3, widths[level + 1], widths[level])
        stack(depth + 1 + i, 2 * widths[level], widths[level])
    convs["UNet_0/Conv_0"] = (1, widths[0], model["out_channels"])
    shapes = {}
    for path, (k, cin, cout) in convs.items():
        shapes[path + "/kernel"] = (k, k, cin, cout)
        shapes[path + "/bias"] = (cout,)
    return shapes


def _cut_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """Standard normal draws, those beyond +-CUT drawn again."""
    z = rng.standard_normal(int(np.prod(shape)))
    bad = np.abs(z) > CUT
    while bad.any():
        z[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(z) > CUT
    return z.reshape(shape)


def draw(model: Mapping, seed: int, gain: float, bias_std: float) -> Dict[str, np.ndarray]:
    """The recipe's parameters, flat Flax paths -> float16 arrays."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, shape in sorted(unet_shapes(model).items()):
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True, help="a configuration name under configs/")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--gain", type=float, required=True)
    p.add_argument("--bias-std", type=float, required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    model = json.loads((HERE / "configs" / f"{args.config}.json").read_text())["model"]
    save(args.out, draw(model, args.seed, args.gain, args.bias_std))
    return 0


if __name__ == "__main__":
    sys.exit(main())
