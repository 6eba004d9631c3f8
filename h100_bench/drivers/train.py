"""Train driver: the program's training step, back to back on a pool of
encoded batches made on the card.

Set-up makes the initial parameters from the seed on the card (every conv
kernel a normal cut at two standard deviations with variance 1/fan_in,
every bias 0, the KPN temperatures at log(3/13), the shapes of the
configuration's release file), builds the program's state with
training/train.create_state from them and its step with make_train_step
(the traffic's recipe as the config's "train" group), makes the pool of
batches on the card from the seed, and drives that state through its first
`warm` steps with the step the window calls, on batches that all differ.
From them it keeps, on the host, each step's loss, the optimiser's first
moment after step 1 (the first gradient as the optimiser got it, times
1 - beta1) and the parameters after step 3. The window then calls step on
the next batches until --seconds have passed and closes with a
synchronize.

After the window the plain reference trains the same parameters on the
same first 3 batches in float32, and these numbers are worked out (those
with a limit in the cell's file are compared):
  loss_gap     the worst step's |loss - ref| / |ref|
  step_gap     the worst leaf's gap between the norms of the parameters'
               change over the 3 steps, over the larger of the reference
               leaf's norm and the median leaf's
  grad_rel_l2  ||first gradient - ref|| / ||ref|| over all leaves.
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of the leaf numbers.
`leaves` works out, for calibration alone, the same gap for the first
gradient (grad_gap) and which leaves read worst.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from h100_bench import program, registry, traffic
from h100_bench.reference import no_tf32
from h100_bench.reference import train as ref_train

CHECKED_STEPS = 3


def init_params(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, np.ndarray]:
    """Flat Flax paths -> fp32 arrays, made on `device` in one draw."""
    d = traffic.draws(seed + 1, device)
    kernels = sorted(n for n in shapes if n.endswith("/kernel"))
    total = sum(int(np.prod(shapes[n])) for n in kernels)
    z = d.normal((total,)).clamp_(-2.0, 2.0).cpu().numpy()
    out, pos = {}, 0
    for n in sorted(shapes):
        shape = shapes[n]
        if n.endswith("/kernel"):
            size = int(np.prod(shape))
            fan_in = shape[0] * shape[1] * shape[2]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            out[n] = (z[pos: pos + size] * std).reshape(shape).astype(np.float32)
            pos += size
        elif n.endswith("/kernel_temp"):
            out[n] = np.full(shape, math.log(3.0 / 13.0), np.float32)
        else:
            out[n] = np.zeros(shape, np.float32)
    return out


def _nested(flat: Dict[str, np.ndarray]) -> dict:
    root: dict = {}
    for path, arr in flat.items():
        node = root
        *scope, leaf = path.split("/")
        for s in scope:
            node = node.setdefault(s, {})
        node[leaf] = arr
    return {"params": root}


def flax_path(torch_name: str) -> str:
    """The program's parameter name -> the release file's Flax path."""
    *scope, leaf = torch_name.split(".")
    return "/".join(scope + ["kernel" if leaf == "weight" else leaf])


def _norms(tree: Dict[str, np.ndarray]) -> Dict[str, float]:
    return {n: float(np.linalg.norm(v.astype(np.float64))) for n, v in tree.items()}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep):
    """(worst gap, its leaf) of |prog - ref| / max(ref, median of ref over
    `keep`) over the leaves in `keep`."""
    med = statistics.median(ref[n] for n in keep)
    worst, at = 0.0, None
    for n in keep:
        gap = abs(prog.get(n, float("inf")) - ref[n]) / max(ref[n], med, 1e-30)
        gap = gap if math.isfinite(gap) else float("inf")
        if gap >= worst:
            worst, at = gap, n
    return worst, at


def moved_leaves(g_ref: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient norm is at least a thousandth of
    the median leaf's; the others move by round-off alone."""
    med = statistics.median(g_ref.values())
    return [n for n, v in g_ref.items() if v >= 1e-3 * med]


def leaves(prog: dict, ref: dict) -> dict:
    """For calibration: grad_gap (the first gradient's worst leaf gap), the
    worst leaves of it and of the change, and how many leaves were left out."""
    g_ref = _norms(ref["grad1"])
    keep = moved_leaves(g_ref)
    grad_gap, grad_leaf = leaf_gap(_norms(prog["grad1"]), g_ref, keep)
    _, step_leaf = leaf_gap(_norms(prog["delta"]), _norms(ref["delta"]), keep)
    return {"grad_gap": grad_gap, "worst_grad_leaf": grad_leaf, "worst_step_leaf": step_leaf,
            "left_out": len(g_ref) - len(keep)}


class Session:
    def __init__(self, cell: registry.Cell, seed: int, device: torch.device):
        from deepdenoiser_tpu_torch.training import train as train_lib

        self.cell, self.seed, self.device = cell, seed, device
        clock = time.perf_counter()
        self.exp = program.experiment(cell)
        self.settings = program.settings(cell)
        arch = registry.reference(cell.config["bench"]["reference"], cell.root)
        shapes = {n: v.shape for n, v in
                  arch.load_params(cell.root.parent / cell.config["bench"]["weights"]).items()}
        self.params0 = init_params(shapes, seed, device)
        t = cell.traffic
        self.batches = traffic.train_batches(t, seed, device, self.exp.data.mode)
        self._sync()
        self.phases = {"parameters and inputs": time.perf_counter() - clock}
        clock = time.perf_counter()
        self.input_bytes = sum(v.numel() * v.element_size() for b in self.batches for v in b.values())
        self.state = train_lib.create_state(self.exp.model, self.exp.train, device=device,
                                            params=_nested(self.params0))
        self.step = train_lib.make_train_step(self.exp.model, self.exp.train)
        self._sync()
        self.phases["state"] = time.perf_counter() - clock
        b1 = self.exp.train.beta1
        self.losses: List[float] = []
        self.grad1: Dict[str, np.ndarray] = {}
        self.params3: Dict[str, np.ndarray] = {}
        named = list(self.state.model.named_parameters())
        self.next = 0
        for s in range(max(t["warm"], CHECKED_STEPS)):
            clock = time.perf_counter()
            self.state, mets = self._step()
            if s < CHECKED_STEPS:
                self.losses.append(float(mets["loss"]))
            if s == 0:
                opt = self.state.optimizer.state
                self.grad1 = {flax_path(n): self._host(opt[p]["exp_avg"]) / (1 - b1)
                              for n, p in named if p in opt}
            if s == CHECKED_STEPS - 1:
                self.params3 = {flax_path(n): self._host(p) for n, p in named}
            self._sync()
            self.phases[f"warm step {s}"] = time.perf_counter() - clock

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        a = t.detach().float().cpu().numpy()
        return np.array(a.transpose(2, 3, 1, 0) if a.ndim == 4 else a, copy=True)

    def _step(self):
        batch = self.batches[self.next % len(self.batches)]
        self.next += 1
        return self.step(self.state, batch)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float, spans) -> dict:
        self._sync()
        start = time.perf_counter()
        steps = 0
        while time.perf_counter() - start < seconds:
            h0 = spans.now()
            self.state, _ = self._step()
            spans.add(f"step call {steps}", h0, spans.now())
            steps += 1
        self._sync()
        return {"window_s": time.perf_counter() - start, "attempted": steps}

    def held_bytes(self) -> int:
        return 0

    def info(self) -> dict:
        return {}

    def release(self) -> None:
        self.state = self.step = None

    def reference(self, f8: bool = False) -> dict:
        """The plain reference's first steps from the same parameters on the
        same batches: per-step losses, first gradients and the change."""
        arch = registry.reference(self.cell.config["bench"]["reference"], self.cell.root)
        model = self.cell.config["model"]
        params = arch.to_device(self.params0, self.device, requires_grad=True)
        with no_tf32():
            res = ref_train.run_steps(lambda p, x: arch.network(p, x, model, f8), params,
                                      self.settings["train"], self.batches[:CHECKED_STEPS])
        host = {n: v.detach().cpu().numpy() for n, v in params.items()}
        return {"loss": res["loss"],
                "grad1": {n: g.cpu().numpy() for n, g in res["grad1"].items()},
                "delta": {n: host[n] - self.params0[n] for n in host}}

    def compare(self, prog: dict, ref: dict) -> Dict[str, float]:
        """The numbers of the program's (or a stand-in's) readings `prog`
        {loss, grad1, delta} against the reference's; a missing step or leaf
        reads inf."""
        if len(prog["loss"]) < CHECKED_STEPS:
            loss_gap = float("inf")
        else:
            loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["loss"], ref["loss"]))
        g_ref = _norms(ref["grad1"])
        keep = moved_leaves(g_ref)
        step_gap, _ = leaf_gap(_norms(prog["delta"]), _norms(ref["delta"]), keep)
        diff = sum(float(np.sum((prog["grad1"][n].astype(np.float64) - ref["grad1"][n]) ** 2))
                   if n in prog["grad1"] else float("inf") for n in keep)
        grad_rel_l2 = math.sqrt(diff / sum(g_ref[n] ** 2 for n in keep))
        return {"loss_gap": loss_gap, "step_gap": step_gap, "grad_rel_l2": grad_rel_l2}

    def readings(self) -> dict:
        return {"loss": self.losses, "grad1": self.grad1,
                "delta": {n: v - self.params0[n] for n, v in self.params3.items()}}

    def check(self) -> List[tuple]:
        """The numbers that have a limit in the cell's file, each with it."""
        limits = self.cell.workload["limits"]
        return [(k, v, limits[k]) for k, v in self.compare(self.readings(), self.reference()).items()
                if k in limits]
