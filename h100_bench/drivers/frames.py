"""Frames driver: multi-pass frames, already on the card, through the
program's frame denoiser one after another (closed loop, one client).

Set-up builds the denoiser with make_joint_frame_denoiser or
make_group_frame_denoiser (by the configuration's data mode, with the
cell's "infer" overrides) from the configuration's release weights, makes
the traffic's pool of frames on the card from the seed, and runs `warm`
frames. The window calls the denoiser on pool[i % pool] until --seconds
have passed; each frame's latency is taken by CUDA events recorded on the
stream around the call, and the frame is complete when the second event
has been reached. The outputs of `check.frames` frames, drawn from the
seed among the first half of the frames the window is expected to
complete, are kept on the card; after the window, the plain reference
denoises their inputs in float32 and every denoised pass and `combined`
is compared: the worst pass's relative L2 gap, ||out - ref|| / ||ref||.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, Tuple

import torch

from h100_bench import program, registry, traffic
from h100_bench.reference import frame as ref_frame
from h100_bench.reference import no_tf32

Tensor = torch.Tensor


def _storages(tensors) -> Dict[int, int]:
    return {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in tensors}


def rel_l2(out: Tensor, ref: Tensor) -> float:
    d = (out.double() - ref.double()).norm()
    return float(d / ref.double().norm().clamp_min(1e-30))


class Session:
    def __init__(self, cell: registry.Cell, seed: int, device: torch.device):
        from deepdenoiser_tpu_torch import weights_io
        from deepdenoiser_tpu_torch.inference import pipeline

        self.cell, self.seed, self.device = cell, seed, device
        clock = time.perf_counter()
        t = cell.traffic
        self.exp = program.experiment(cell)
        self.settings = program.settings(cell)
        make = {"joint": pipeline.make_joint_frame_denoiser,
                "group": pipeline.make_group_frame_denoiser}[self.exp.data.mode]
        params = weights_io.load_release_params(cell.root.parent / cell.config["bench"]["weights"])
        self.denoise, self.grid = make(self.exp.model, self.exp.infer, t["height"], t["width"],
                                       params, device=device)
        self._sync()
        self.phases = {"denoiser": time.perf_counter() - clock}
        clock = time.perf_counter()
        self.frames = traffic.frames(t, seed, device)
        self._sync()
        self.phases["inputs"] = time.perf_counter() - clock
        self.input_bytes = sum(sum(v.numel() * v.element_size() for v in f.values())
                               for f in self.frames)
        self._inputs = _storages(v for f in self.frames for v in f.values())
        self.held: List[Tuple[int, int, Dict[str, Tensor]]] = []
        self.frame_s = 0.0
        for i in range(t["warm"]):
            t0 = time.perf_counter()
            self.denoise(self.frames[i % len(self.frames)])
            self._sync()
            self.frame_s = time.perf_counter() - t0
            self.phases[f"warm frame {i}"] = self.frame_s

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float, spans) -> dict:
        n_check = self.cell.workload["check"]["frames"]
        expected = max(2 * n_check, int(seconds / max(self.frame_s, 1e-6)))
        keep = set(random.Random(self.seed).sample(range(expected // 2), n_check))
        cuda = self.device.type == "cuda"
        if cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        lat: List[float] = []
        pool = len(self.frames)
        self._sync()
        start = time.perf_counter()
        i = 0
        while True:
            f = i % pool
            h0 = spans.now()
            if cuda:
                e0.record()
                out = self.denoise(self.frames[f])
                e1.record()
                e1.synchronize()
                lat.append(e0.elapsed_time(e1))
            else:
                t0 = time.perf_counter()
                out = self.denoise(self.frames[f])
                lat.append(1e3 * (time.perf_counter() - t0))
            spans.add(f"frame call {i}", h0, spans.now())
            if i in keep:
                self.held.append((i, f, out))
            del out
            i += 1
            if time.perf_counter() - start >= seconds:
                break
        return {"window_s": time.perf_counter() - start, "attempted": i, "latencies_ms": lat}

    def held_bytes(self) -> int:
        """Bytes of the kept outputs that are not the inputs' (pass-through
        passes alias the input frame)."""
        own = _storages(t for _, _, out in self.held for t in out.values())
        return sum(-(-n // 512) * 512 for p, n in own.items() if p not in self._inputs)

    def info(self) -> dict:
        return {"grid": self.grid, "infer": self.settings["infer"]}

    def release(self) -> None:
        self.denoise = None

    def references(self, f8: bool = False) -> Dict[int, Dict[str, Tensor]]:
        """The plain reference's outputs for each kept frame's input (float32,
        or with float8 conv operands), by pool index."""
        model = self.cell.config["model"]
        arch = registry.reference(self.cell.config["bench"]["reference"], self.cell.root)
        p = arch.to_device(arch.load_params(self.cell.root.parent / self.cell.config["bench"]["weights"]),
                           self.device)
        certified = arch.halo(model)
        m = 2 ** model["depth"] * model["stem_stride"]
        halo = ref_frame.plane_halo(self.settings["infer"], certified, m)
        context = -(-certified // m) * m
        band = self.cell.workload["check"]["band_rows"]
        refs = {}
        with no_tf32():
            for f in sorted({f for _, f, _ in self.held}):
                refs[f] = ref_frame.denoise(lambda x: arch.network(p, x, model, f8),
                                            self.frames[f], self.settings["data"]["mode"], halo, context,
                                            m, band)
        return refs

    def compare(self, outs: List[Tuple[int, Dict[str, Tensor]]], refs) -> Dict[str, float]:
        """The worst pass's relative L2 gap over the given (pool index,
        output) pairs; a missing pass or frame reads inf."""
        worst = float("inf") if not outs else 0.0
        for f, out in outs:
            for name, r in refs[f].items():
                o = out.get(name)
                gap = rel_l2(o, r) if o is not None and o.shape == r.shape else float("inf")
                worst = max(worst, gap)
        return {"rel_l2": worst}

    def check(self) -> List[tuple]:
        """The numbers that have a limit in the cell's file, each with it."""
        limits = self.cell.workload["limits"]
        got = self.compare([(f, out) for _, f, out in self.held], self.references())
        return [(k, v, limits[k]) for k, v in got.items() if k in limits]

