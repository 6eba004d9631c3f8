"""flagship-hq at lr 1e-3 with no warm-up, one fixed batch: the port's
train step against the JAX package's from the same carried-across
parameters, on the CPU (fp32 unless --dtype says bfloat16).

On the card, flagship-hq's loss on one fixed batch (bf16, batch 16, crop
96, Adam lr 1e-3 constant) climbs after about a dozen steps. This file
tells whether the recipe or the port does that: both packages take the
same steps from the same parameters on the same batch.

    PYTHONPATH=. python tests/torch_flagship_hq_recipe.py [--steps 30] [--batch 2] [--crop 64] [--dtype float32]

prints both loss curves, step by step (under a minute on 8 CPU cores).
It imports both packages, so it lives beside the tests; it is a script,
not a test (pytest does not collect it): the full-width model takes too
long for the suite.
"""

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepdenoiser_tpu import config as jconfig
from deepdenoiser_tpu.models import factory as jfactory
from deepdenoiser_tpu.training import train as jtrain
from deepdenoiser_tpu_torch import config
from deepdenoiser_tpu_torch.data import loader, prepare, shards, synthetic
from deepdenoiser_tpu_torch.models import factory
from deepdenoiser_tpu_torch.training import train

RECIPE = dict(learning_rate=1e-3, warmup_steps=0, schedule="constant", ema_decay=0.999)


def _fixed_batch(n: int, crop: int, seed: int = 0) -> dict:
    """One encoded joint batch: n Fourier-family crops at spp 4 against
    their clean passes, as the loader encodes them."""
    raw = {}
    for i in range(n):
        clean = synthetic.generate_clean_passes(crop, crop, seed=seed + 2 * i)
        noisy = synthetic.add_mc_noise(clean, spp=4, seed=seed + 2 * i + 1)
        for role, d, names in (("source", noisy, prepare.default_source_passes()),
                               ("target", clean, prepare.default_target_passes())):
            for p in names:
                raw.setdefault(f"{role}/{p}", []).append(d[p].astype(shards._disk_dtype(p)))
    raw = {k: torch.from_numpy(np.stack(v)) for k, v in raw.items()}
    enc = loader.make_batch_encoder(config.DataConfig(mode="joint"))(raw)
    return {k: v.numpy() for k, v in enc.items()}


def _model_kw(dtype: str, **cut) -> dict:
    """flagship-hq's model at its 41 joint input channels, computing in
    `dtype` (the preset computes in bf16)."""
    model = config.validate_channels(config.PRESETS["flagship-hq"]).model
    return {**vars(model), "compute_dtype": dtype, **cut}


def loss_curves(model_kw: dict, steps: int, batch: dict) -> tuple:
    """(JAX losses, port losses, JAX grad norms, port grad norms) over
    `steps` steps of RECIPE from the same parameters on `batch`."""
    jm, jt = jfactory.ModelConfig(**model_kw), jconfig.TrainConfig(**RECIPE)
    m, t = factory.ModelConfig(**model_kw), config.TrainConfig(**RECIPE)
    jstate = jtrain.create_state(jm, jt, jax.random.PRNGKey(0), spatial=16)
    state = train.create_state(m, t, device="cpu",
                               params=jax.tree.map(np.asarray, jstate.params))
    jstep, step = jtrain.make_train_step(jm, jt), train.make_train_step(m, t)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    curves = ([], [], [], [])
    for _ in range(steps):
        jstate, jmets = jstep(jstate, jbatch)
        state, mets = step(state, tbatch)
        for curve, v in zip(curves, (jmets["loss"], mets["loss"], jmets["grad_norm"],
                                     mets["grad_norm"])):
            curve.append(float(v))
    return curves


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--crop", type=int, default=64)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    torch.manual_seed(0)
    model_kw = _model_kw(args.dtype)
    t0 = time.perf_counter()
    jl, tl, jg, tg = loss_curves(model_kw, args.steps, _fixed_batch(args.batch, args.crop))
    print(f"flagship-hq, {args.dtype} on the CPU, batch {args.batch}, crop {args.crop}, Adam lr "
          f"{RECIPE['learning_rate']} constant, no warm-up, clip 1.0; {args.steps} steps in "
          f"{time.perf_counter() - t0:.0f} s")
    print("step  loss JAX     loss port    grad_norm JAX  grad_norm port")
    for i, row in enumerate(zip(jl, tl, jg, tg), start=1):
        print(f"{i:4d}  " + "  ".join(f"{v:.7g}" for v in row))


if __name__ == "__main__":
    main()
