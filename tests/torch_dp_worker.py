"""Data-parallel ranks for the port's tests (a helper of the tests/test_torch_*
files; pytest does not collect it). It imports torch and the port only:
`spawn` starts fresh processes that import this module, not the test
module that called it, so the ranks never load JAX.

`spawn(fn, world, tmp_path, device, *args)` starts `world` ranks with
torch.multiprocessing's spawn method and a file:// rendezvous under
`tmp_path` (no port to pick, so it is safe beside other test workers).
Rank r joins the group (parallel/dist.init), calls fn(group, *args),
and saves what fn returns; spawn returns the ranks' results in rank
order. A rank that fails stops the others, and spawn raises its error;
ranks still running after `timeout` seconds are killed and spawn raises
TimeoutError.
"""

import os
import signal
import time
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as tmp

from deepdenoiser_tpu_torch import config, weights_io
from deepdenoiser_tpu_torch.models import factory
from deepdenoiser_tpu_torch.ops import kpn_apply
from deepdenoiser_tpu_torch.parallel import dist
from deepdenoiser_tpu_torch.training import loop, train


def _entry(rank, fn, world, init_method, out_dir, device, args):
    group = dist.init(rank, world, init_method, device=device)
    try:
        result = fn(group, *args)
    finally:
        dist.shutdown(group)
    torch.save(result, Path(out_dir) / f"rank{rank}.pt")


def spawn(fn, world, tmp_path, device, *args, timeout=300.0):
    out = Path(tmp_path) / f"ranks-{fn.__name__}"
    out.mkdir(parents=True, exist_ok=True)
    init_method = f"file://{out / 'rendezvous'}"
    ctx = tmp.start_processes(_entry, args=(fn, world, init_method, str(out), device, args),
                              nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):  # raises as soon as a rank fails
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks of {fn.__name__} still running after {timeout} s")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def share(batch, group):
    """Rank r's rows [r*B/N, (r+1)*B/N) of a global batch, on its device."""
    n = next(iter(batch.values())).shape[0] // group.world
    return {k: torch.as_tensor(np.asarray(v)[group.rank * n : (group.rank + 1) * n]).to(group.device)
            for k, v in batch.items()}


def flat_state(state):
    """{name: numpy} of the parameters, the EMA and Adam's moments."""
    out = {f"params/{k}": v for k, v in
           weights_io.flatten(weights_io.params_from_state_dict(state.model.state_dict())).items()}
    if state.ema_params is not None:
        out.update({f"ema/{k}": v for k, v in weights_io.flatten(
            weights_io.params_from_state_dict(state.ema_params)).items()})
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"opt/{i}/{k}": torch.as_tensor(v).cpu().numpy() for k, v in st.items()})
    return out


def train_steps(group, mkw, tkw, params, batch, steps, raw=None, data_cfg=None):
    """`steps` data-parallel train steps of the model `mkw` from `params`
    (a flat Flax tree) on this rank's share of the global `batch`: every
    step's metrics, the K1 forward and d_w launches a step, the final
    state; and, given a raw batch, the full eval step's metrics on this
    rank's share of it."""
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False  # fp32 on the card
    m = factory.ModelConfig(**mkw)
    t = config.TrainConfig(**tkw)
    state = train.create_state(m, t, device=group.device, params=weights_io.unflatten(params))
    step = train.make_train_step(m, t, group)
    mine = share(batch, group)
    mets, launches = [], []
    for _ in range(steps):
        kpn_apply.reset_launches()
        state, out = step(state, mine)
        mets.append({k: float(v) for k, v in out.items()})
        launches.append((kpn_apply.launches, kpn_apply.bwd_weights_launches))
    res = {"mets": mets, "launches": launches, "state": flat_state(state)}
    if raw is not None:
        evaluate = train.make_full_eval_step(m, data_cfg, t.loss, group)
        res["eval"] = {k: float(v) for k, v in evaluate(state, share(raw, group)).items()}
    return res


def fit_ranks(group, cfg, shards, workdir, max_steps, sigterm_cfg=None, sigterm_workdir=None):
    """fit for max_steps (one checkpoint at its end), then resumed to
    cfg.train.steps; then, with sigterm_cfg, a fit in which rank 1 alone
    gets a SIGTERM after its second step."""
    first = loop.fit(cfg, workdir, shard_dir=str(shards), max_steps=max_steps, group=group)
    ckpts = Path(workdir) / cfg.train.checkpoint_dir
    res = {"first_step": first.step, "first": flat_state(first),
           "first_checkpoints": sorted(int(p.name) for p in ckpts.iterdir() if p.name.isdigit())}
    resumed = loop.fit(cfg, workdir, shard_dir=str(shards), group=group)
    res.update(resumed_step=resumed.step, resumed=flat_state(resumed))
    if sigterm_cfg is not None:
        make = train.make_train_step

        def make_with_sigterm(mcfg, tcfg, grp=None):
            step = make(mcfg, tcfg, grp)

            def stepped(state, batch):
                state, mets = step(state, batch)
                if grp.rank == 1 and state.step == 2:
                    os.kill(os.getpid(), signal.SIGTERM)
                return state, mets

            return stepped

        train.make_train_step = make_with_sigterm
        stopped = loop.fit(sigterm_cfg, sigterm_workdir, shard_dir=str(shards), group=group)
        train.make_train_step = make
        res["sigterm_step"] = stopped.step
    return res
