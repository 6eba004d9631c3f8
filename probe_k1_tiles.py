"""K1's forward in each tile variant at each path shape, on one CUDA card.

    python3 probe_k1_tiles.py

csrc/kpn_apply.cu picks its tiles from the launch's size: 32x8 tiles, two
pixels a thread, unless every 32x8 tile fits in one wave of the card; then
32x4 tiles, a pixel a thread. This script measures that choice. It builds
copies of the source under build/ that also export a launch of either tile
height, one copy as written (128-thread blocks) and one with 64-thread
blocks (two or four pixels a thread, the variant the design set aside),
holds every variant to the plain version and to the entry point's own
result (bitwise: the same taps in the same order), and times them
interleaved, five rounds, at the four path shapes of chip_smoke.py phase 3
(k=5, C=3, the head's contiguous softmax weights, slot views of the
signal). The package's entry points take no tile argument; only these
copies do. Prints a line per shape and variant, the card's name and power
limit, and last one JSON object of the medians in microseconds.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

import torch

import chip_smoke as smoke
from deepdenoiser_tpu_torch.models import kpn
from deepdenoiser_tpu_torch.ops import _build, kpn_apply

OUT = smoke.ROOT / "build" / "probe_k1_tiles"
ROUNDS = 5
K = 5
# (threads a block, tile rows): 32 * rows / threads pixels a thread
VARIANTS = [(128, 8), (128, 4), (64, 4), (64, 8)]
SHAPES = {  # path -> (N,H,W,C), channels of the stack the slot is cut from
    "joint": ((1, smoke.PLANE_H, smoke.PLANE_W, 3), 24),
    "group": ((4, smoke.PLANE_H, smoke.PLANE_W, 3), 14),
    "tile": ((smoke.TILE_BATCH, smoke.NET_TILE, smoke.NET_TILE, 3), 24),
    "train": ((smoke.TRAIN_BATCH, smoke.TRAIN_CROP, smoke.TRAIN_CROP, 3), 24),
}
EXPORT = r"""
extern "C" int probe_launch(int rows, const float* noisy, const float* weights, float* out,
                            int n, int h, int w, const long long* s, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 8) return launch_rows<5, 3, 8>(noisy, weights, out, n, h, w, s, st);
  if (rows == 4) return launch_rows<5, 3, 4>(noisy, weights, out, n, h, w, s, st);
  return cudaErrorInvalidValue;
}
"""


def build() -> dict:
    """threads -> the loaded copy of csrc/kpn_apply.cu with that block size."""
    src = (_build.CSRC / "kpn_apply.cu").read_text()
    line = "constexpr int NT = 128;"
    if line not in src:
        raise RuntimeError(f"csrc/kpn_apply.cu has no `{line}`")
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for threads in sorted({t for t, _ in VARIANTS}):
        cu, so = OUT / f"kpn_apply_nt{threads}.cu", OUT / f"kpn_apply_nt{threads}.so"
        cu.write_text(src.replace(line, f"constexpr int NT = {threads};") + EXPORT)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
        procs[threads] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True))
    libs = {}
    for threads, (so, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {threads}-thread blocks:\n{report}")
        lib = ctypes.CDLL(str(so))
        lib.probe_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                                     + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
        lib.probe_launch.restype = ctypes.c_int
        lib.kpn_apply_resident_blocks.argtypes = [ctypes.c_int] * 3
        lib.kpn_apply_resident_blocks.restype = ctypes.c_int
        libs[threads] = lib
    return libs


def launcher(lib, rows: int):
    def run(noisy, weights):
        n, h, w, _ = noisy.shape
        out = torch.empty(noisy.shape, device=noisy.device)
        strides = (ctypes.c_longlong * 8)(*noisy.stride(), *kpn_apply._w_strides(weights))
        err = lib.probe_launch(rows, noisy.data_ptr(), weights.data_ptr(), out.data_ptr(),
                               n, h, w, strides, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"probe launch failed with cudaError {err}")
        return out
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_k1_tiles: no CUDA device", file=sys.stderr)
        return 1
    smi = smoke.nvidia_smi_line()
    libs = build()
    variants = {"entry point": lambda a, b: kpn_apply.apply_cuda(a, b, K)}
    for threads, rows in VARIANTS:
        name = f"{threads} threads, 32x{rows}, {32 * rows // threads} px a thread"
        variants[name] = launcher(libs[threads], rows)
        print(f"[probe] {name}: {libs[threads].kpn_apply_resident_blocks(K, 3, rows)} "
              "resident blocks/SM (occupancy API)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    medians = {}
    for path, (shape, stack) in SHAPES.items():
        # the training batch's 10 us launches by graph replay over buffer
        # sets larger than the L2, as chip_smoke.py phase 3 times them
        sets = [smoke._kpn_inputs(shape, K, stack, gen) for _ in range(11 if path == "train" else 1)]
        ref = kpn.apply_per_pixel_kernels(*sets[0], K)
        chosen = variants["entry point"](*sets[0])
        for name, fn in variants.items():
            got = fn(*sets[0])
            if not (got - ref).abs().le(smoke.TOL_ABS + smoke.TOL_REL * ref.abs()).all():
                raise AssertionError(f"{name} disagrees with the plain version at {shape}")
            if not torch.equal(got, chosen):
                raise AssertionError(f"{name} differs from the entry point's result at {shape}")
        del ref, chosen, got
        times = {name: [] for name in variants}
        for r in range(ROUNDS):
            for name in list(variants)[:: 1 if r % 2 == 0 else -1]:
                fn = variants[name]
                if path == "train":
                    ms = smoke.graph_ms([lambda b=b, fn=fn: fn(*b) for b in sets])
                else:
                    ms = smoke.cuda_ms(lambda fn=fn: fn(*sets[0]), iters=200 // shape[0])
                times[name].append(ms * 1e3)
        rows = kpn_apply.tile_rows(shape, K)
        medians[path] = {"shape": list(shape), "entry_point_rows": rows,
                         "us": {name: statistics.median(t) for name, t in times.items()}}
        for name, t in times.items():
            print(f"[probe] {path} {shape} (entry point takes 32x{rows}): {name}: median "
                  f"{statistics.median(t):.2f} us, rounds {', '.join(f'{x:.2f}' for x in t)}")
        del sets
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps(medians))
    return 0


if __name__ == "__main__":
    sys.exit(main())
