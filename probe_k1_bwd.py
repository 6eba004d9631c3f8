"""K1's backward kernels against the planar-d_w ones, on one CUDA card.

    python3 probe_k1_bwd.py --parent-csrc DIR [--steps N]

DIR holds the csrc/ of a tree whose d_w kernel writes the planar
(N,k²,H,W) layout (for instance `git archive <commit>
deepdenoiser_tpu_torch/csrc` unpacked under build/, which .gitignore
lists); chip_smoke.planar_backward builds it. Beside it, a copy of this
tree's csrc/kpn_apply_bwd.cu that also exports a launch of other tile
heights (a warp a tile row: d_w 32x4 tiles as the entry point takes them,
32x8 and 32x2; d_noisy 32x4 and 32x2; the package's entry points take no
tile argument). At the kpn-hq train step's shapes (the training batch's
slot views 0 and 2 and a contiguous (16,96,96,3), and the joint 1080p
plane's slot 0; k=5, C=3, the head's contiguous softmax weights) every
variant is held to the plain backward and to the entry point's result
(bitwise; the planar d_w through its (N,H,W,k²) view) and timed by
CUDA-graph replay over buffer sets larger than the L2, in turns, five
rounds.

Then the kpn-hq train step (make_train_step, batch 16, crop 96, bf16,
seeded random weights and batch) with the weight gradient from this
tree's entry point, from DIR's kernel behind the same checks and launch,
and from this tree's made planar on purpose (the other layout, copied),
in four turns each (A B C C B A, twice): device copies a step (their
launches and ms), device busy ms a step (torch.profiler over 3 steps) and
the host-clock ms a step (median of `--steps` a turn, each closed by
reading its loss).

Prints a line per measurement, the card's name and power limit, and last
one JSON object of the medians.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as smoke
from deepdenoiser_tpu_torch.models import kpn
from deepdenoiser_tpu_torch.ops import _build, kpn_apply

OUT = smoke.ROOT / "build" / "probe_k1_bwd"
ROUNDS = 5
K = 5
EXPORT = r"""
extern "C" int probe_weights(int rows, const float* noisy, const float* g, float* dw, int n,
                             int h, int w, const long long* s, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 8) return launch_weights<5, 3, 8>(noisy, g, dw, n, h, w, s, st);
  if (rows == 4) return launch_weights<5, 3, 4>(noisy, g, dw, n, h, w, s, st);
  if (rows == 2) return launch_weights<5, 3, 2>(noisy, g, dw, n, h, w, s, st);
  return cudaErrorInvalidValue;
}
extern "C" int probe_noisy(int rows, const float* g, const float* weights, float* dn, int n,
                           int h, int w, const long long* s, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 4) return launch_noisy<5, 3, 4>(g, weights, dn, n, h, w, s, st);
  if (rows == 2) return launch_noisy<5, 3, 2>(g, weights, dn, n, h, w, s, st);
  return cudaErrorInvalidValue;
}
template <typename F>
int resident(F kernel, int threads) {
  int b = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, threads, 0);
  return b;
}
extern "C" int probe_resident(int which, int rows) {
  if (which == 0 && rows == 8) return resident(kpn_bwd_weights_kernel<5, 3, 8>, 256);
  if (which == 0 && rows == 4) return resident(kpn_bwd_weights_kernel<5, 3, 4>, 128);
  if (which == 0 && rows == 2) return resident(kpn_bwd_weights_kernel<5, 3, 2>, 64);
  if (which == 1 && rows == 4) return resident(kpn_bwd_noisy_kernel<5, 3, 4>, 128);
  if (which == 1 && rows == 2) return resident(kpn_bwd_noisy_kernel<5, 3, 2>, 64);
  return 0;
}
"""
PATHS = {  # path -> (N,H,W,C), slot views timed (None: a contiguous tensor)
    "train": ((smoke.TRAIN_BATCH, smoke.TRAIN_CROP, smoke.TRAIN_CROP, 3), (0, 2, None)),
    "plane": ((1, smoke.PLANE_H, smoke.PLANE_W, 3), (0,)),
}


def build() -> ctypes.CDLL:
    """This tree's copy of csrc/kpn_apply_bwd.cu with the probe exports."""
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / "kpn_apply_bwd_probe.cu", OUT / "kpn_apply_bwd_probe.so"
    cu.write_text((_build.CSRC / "kpn_apply_bwd.cu").read_text() + EXPORT)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    entry = ""
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif "ILi5ELi3E" in entry and ("Used" in line or "spill" in line):
            print(f"[build] {entry.split()[-3]} {line.split(':', 1)[-1].strip()}")
    lib = ctypes.CDLL(str(so))
    for fn in (lib.probe_weights, lib.probe_noisy):
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    lib.probe_resident.argtypes, lib.probe_resident.restype = [ctypes.c_int] * 2, ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: launch failed with cudaError {err}")


def probe_weights(lib, rows: int):
    def run(noisy, g, k):
        n, h, w, _ = noisy.shape
        dw = torch.empty((n, h, w, k * k), device=noisy.device)
        s = (ctypes.c_longlong * 8)(*noisy.stride(), *g.stride())
        _check(lib.probe_weights(rows, noisy.data_ptr(), g.data_ptr(), dw.data_ptr(), n, h, w, s,
                                 torch.cuda.current_stream().cuda_stream), f"d_w 32x{rows}")
        return dw
    return run


def probe_noisy(lib, rows: int):
    def run(g, weights, k):
        n, h, w, c = g.shape
        dn = torch.empty((n, h, w, c), device=g.device)
        s = (ctypes.c_longlong * 8)(*g.stride(), *kpn_apply._w_strides(weights))
        _check(lib.probe_noisy(rows, g.data_ptr(), weights.data_ptr(), dn.data_ptr(), n, h, w, s,
                               torch.cuda.current_stream().cuda_stream), f"d_noisy 32x{rows}")
        return dn
    return run


def kernels(probe, parent: dict, smi: str) -> dict:
    variants = {
        "bwd_weights": {"entry point (32x4)": kpn_apply.bwd_weights_cuda,
                        "32x8": probe_weights(probe, 8), "32x2": probe_weights(probe, 2),
                        "parent": parent["bwd_weights"]},
        "bwd_noisy": {"entry point (32x4)": kpn_apply.bwd_noisy_cuda,
                      "32x2": probe_noisy(probe, 2), "parent": parent["bwd_noisy"]},
    }
    for which, (entry, rows) in enumerate((("bwd_weights", (4, 8, 2)), ("bwd_noisy", (4, 2)))):
        print(f"[probe] {entry} resident blocks/SM (occupancy API): "
              + ", ".join(f"32x{r} {probe.probe_resident(which, r)}" for r in rows))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    res = {}
    for path, (shape, slots) in PATHS.items():
        for slot in slots:
            label = f"{path} {smoke._bwd_label(slot)}"
            first = smoke._bwd_inputs(shape, K, gen, slot)
            work = smoke._bwd_work("bwd_weights", *first, K)
            sets = max(2, min(16, -(-4 * int(smoke.H100_L2_BYTES) // work["bytes"])))
            bufs = [first] + [smoke._bwd_inputs(shape, K, gen, slot) for _ in range(sets - 1)]
            noisy, weights, g = first
            ref_n, ref_w = kpn.apply_per_pixel_kernels_bwd(noisy, weights, g, K, True)
            for entry, fns in variants.items():
                ref = ref_w if entry == "bwd_weights" else ref_n
                args = (noisy, g) if entry == "bwd_weights" else (g, weights)
                mine = None
                for name, fn in fns.items():
                    got = fn(*args, K)
                    bad = int((got - ref).abs().gt(smoke.TOL_ABS + smoke.TOL_REL * ref.abs()).sum())
                    mine = got if mine is None else mine
                    if bad or not torch.equal(got, mine):
                        raise AssertionError(f"{entry} {name} at {label}: {bad} elements beyond "
                                             "the tolerance, or not bitwise the entry point's")
                times = {name: [] for name in fns}
                for r in range(ROUNDS):
                    for name in list(fns)[:: 1 if r % 2 == 0 else -1]:
                        fn = fns[name]
                        calls = [lambda b=b, fn=fn: fn(b[0], b[2], K) for b in bufs] \
                            if entry == "bwd_weights" else [lambda b=b, fn=fn: fn(b[2], b[1], K)
                                                            for b in bufs]
                        times[name].append(smoke.graph_ms(calls) * 1e3)
                bound_us = smoke._bwd_work(entry, *first, K)["bytes"] / smoke.H100_BYTES_PER_S * 1e6
                res[f"{entry} {label}"] = {"bound_us": bound_us, "buffer_sets": sets,
                                           **{n: statistics.median(t) for n, t in times.items()}}
                for name, t in times.items():
                    print(f"[probe] {entry} {shape} {label}: {name} median "
                          f"{statistics.median(t):.2f} us (rounds "
                          f"{', '.join(f'{x:.2f}' for x in t)}); bound {bound_us:.2f} us; "
                          f"{sets} buffer sets | {smi}")
            del bufs, first, noisy, weights, g, ref_n, ref_w
            torch.cuda.empty_cache()
    return res


def _profiled_step(run, steps: int = 3) -> dict:
    """Device busy ms, copy launches and copy ms a step (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    copies = [e for e in events if "direct_copy" in e.key or "Memcpy" in e.key]
    return {"busy_ms": sum(e.self_device_time_total for e in events) / steps / 1e3,
            "copy_launches": sum(e.count for e in copies) / steps,
            "copy_ms": sum(e.self_device_time_total for e in copies) / steps / 1e3,
            "copy_rows": {e.key[:100]: [e.count / steps, e.self_device_time_total / steps / 1e3]
                          for e in copies}}


def train_step(parent: dict, smi: str, steps: int) -> dict:
    from deepdenoiser_tpu_torch import config
    from deepdenoiser_tpu_torch.training import train as train_lib

    cfg = config.PRESETS["kpn-hq"]
    mcfg = config.validate_channels(cfg).model
    tcfg = dataclasses.replace(cfg.train, learning_rate=2.5e-4, warmup_steps=0,
                               schedule="constant")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    shape = (smoke.TRAIN_BATCH, smoke.TRAIN_CROP, smoke.TRAIN_CROP)
    batch = {"x": torch.rand((*shape, mcfg.in_channels), generator=gen, device="cuda"),
             "y": torch.rand((*shape, mcfg.out_channels), generator=gen, device="cuda")}
    state = train_lib.create_state(mcfg, tcfg, seed=0)
    step = train_lib.make_train_step(mcfg, tcfg)
    mine = kpn_apply.bwd_weights_cuda

    def planar(noisy, g, k):
        return mine(noisy, g, k).permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)

    variants = {"this tree": mine, "parent": parent["bwd_weights"], "made planar": planar}
    for _ in range(5):
        state, _ = step(state, batch)
    res = {name: {"ms": [], "profiles": []} for name in variants}
    order = ["parent", "this tree", "made planar", "made planar", "this tree", "parent"] * 2
    try:
        for name in order:
            kpn_apply.bwd_weights_cuda = variants[name]
            state, _ = step(state, batch)
            for _ in range(steps):
                t0 = time.perf_counter()
                state, mets = step(state, batch)
                float(mets["loss"])
                res[name]["ms"].append((time.perf_counter() - t0) * 1e3)

            def run():
                nonlocal state
                state, _ = step(state, batch)

            res[name]["profiles"].append(_profiled_step(run))
    finally:
        kpn_apply.bwd_weights_cuda = mine
    out = {}
    for name, r in res.items():
        p = r["profiles"]
        counts = ", ".join(f"{x['copy_launches']:.0f}" for x in p)
        turns = ", ".join(f"{statistics.median(r['ms'][i:i + steps]):.2f}"
                          for i in range(0, len(r["ms"]), steps))
        out[name] = {"ms": statistics.median(r["ms"]),
                     **{key: statistics.mean(x[key] for x in p)
                        for key in ("busy_ms", "copy_launches", "copy_ms")}}
        print(f"[probe] kpn-hq train step, d_w from {name}: {out[name]['ms']:.2f} ms/step "
              f"(median of {len(r['ms'])} in 4 turns: {turns}; host clock, each closed by reading "
              f"its loss); device busy {out[name]['busy_ms']:.3f} ms/step; copies "
              f"{out[name]['copy_launches']:.2f} launches, {out[name]['copy_ms']:.3f} ms a step "
              f"(profiles {counts}) | {smi}")
        for key, (count, ms) in sorted(p[0]["copy_rows"].items(), key=lambda kv: -kv[1][1]):
            print(f"[probe]   {name}: copy {ms:8.3f} ms {count:6.2f}x  {key}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-csrc", type=Path, required=True,
                    help="another commit's deepdenoiser_tpu_torch/csrc directory")
    ap.add_argument("--steps", type=int, default=20, help="timed train steps a turn")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_k1_bwd: no CUDA device", file=sys.stderr)
        return 1
    smi = smoke.nvidia_smi_line()
    probe, parent = build(), smoke.planar_backward(args.parent_csrc.resolve())
    res = {"kernels": kernels(probe, parent, smi), "train_step": train_step(parent, smi, args.steps)}
    print(smi)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
