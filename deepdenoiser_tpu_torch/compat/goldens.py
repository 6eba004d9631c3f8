"""The frozen TF-checkpoint goldens: checked by the port, and made by it.

The JAX package pins one set of artifacts per zoo family on disk
(deepdenoiser_tpu/compat/goldens.py):

    tests/goldens/tf_compat/<fam>/model.ckpt.*   frozen TF1 checkpoint
    tests/goldens/tf_compat/<fam>/io.npz         pinned input x, fp32 output y

`check()` imports a checkpoint through compat/tf_checkpoint.py, carries it
into the port's model and forwards the pinned input on the given device:
the output must match the saved one within ATOL. On the card the forward
runs in full fp32 (TF32 off for cuDNN and matmuls), as the goldens were
made; the `kpn` family launches the KPN filter apply (k=3) once per slot,
twice.

`make()` writes the same three artifacts from the port: the model
initialised as Flax initialises it (`factory.init_model`, seed 7), its
parameters through the port's TF writer, and the fp32 forward of a pinned
input. The JAX package's `check(fam, indir=...)` reads them back, so the
parity is held from both sides. The port's pinned input is drawn by
numpy (seed 11), not by jax.random, so its artifacts are its own and not
bit-equal to the committed ones; the committed ones are never rewritten
here. Two `make` calls write byte-identical files.
"""

from __future__ import annotations

import contextlib
import io
import zipfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from deepdenoiser_tpu_torch import device as device_lib
from deepdenoiser_tpu_torch import weights_io
from deepdenoiser_tpu_torch.compat import tf_checkpoint as tfc
from deepdenoiser_tpu_torch.models import factory
from deepdenoiser_tpu_torch.models.factory import ModelConfig

ATOL = 2e-5
SPATIAL = 64  # pinned-input size

# Tiny twins of the four shipped families. FROZEN: these are the configs
# the committed goldens were made with.
GOLDEN_CFGS: Dict[str, ModelConfig] = {
    "unet": ModelConfig(backbone="unet", in_channels=5, out_channels=3,
                        base_width=8, depth=2, convs_per_level=2,
                        act="leaky_relu"),
    "tiramisu": ModelConfig(backbone="tiramisu", in_channels=5, out_channels=3,
                            growth_rate=4, layers_per_block=2, depth=2,
                            up_compress=8, layers_top=1, act="leaky_relu"),
    "multiscale": ModelConfig(backbone="unet", in_channels=5, out_channels=3,
                              base_width=8, depth=2, convs_per_level=1,
                              n_scales=2, act="leaky_relu"),
    "kpn": ModelConfig(backbone="unet", in_channels=8, out_channels=6,
                       base_width=8, depth=2, convs_per_level=1,
                       kernel_prediction=True, kpn_size=3, kpn_slots=2,
                       kpn_logit_norm=True, act="leaky_relu"),
}


def golden_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "tests" / "goldens" / "tf_compat"


@contextlib.contextmanager
def _full_fp32():
    """TF32 off for cuDNN convs and matmuls inside the block."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _forward_fp32(model: torch.nn.Module, x: np.ndarray, dev: torch.device) -> np.ndarray:
    """The model's output on `x`, forwarded on `dev` in full fp32."""
    with torch.no_grad(), _full_fp32():
        return model(torch.from_numpy(x).to(dev)).float().cpu().numpy()


def _pinned_input(fam: str) -> np.ndarray:
    cfg = GOLDEN_CFGS[fam]
    return np.random.default_rng(11).standard_normal(
        (1, SPATIAL, SPATIAL, cfg.in_channels), dtype=np.float32)


def _save_npz(path: Path, **arrays: np.ndarray) -> None:
    """np.savez with a fixed member timestamp, so equal arrays give equal
    bytes (np.savez stamps each member with the current time)."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for name, arr in arrays.items():
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.asarray(arr))
            zf.writestr(zipfile.ZipInfo(f"{name}.npy", date_time=(1980, 1, 1, 0, 0, 0)),
                        buf.getvalue())


def make(fam: str, outdir: Path, device=None) -> None:
    """Write one family's artifacts into `outdir`: model.ckpt.{index,data}
    of the model initialised from seed 7, and io.npz with the pinned input
    x and its fp32 forward y on `device` (the card unless the caller asks
    for the CPU)."""
    dev = device_lib.resolve(device)
    cfg = GOLDEN_CFGS[fam]
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    model = factory.init_model(cfg, torch.Generator().manual_seed(7)).to(dev).eval()
    params = weights_io.params_from_state_dict(model.state_dict())
    tfc.export_checkpoint(params, cfg, outdir / "model.ckpt")
    x = _pinned_input(fam)
    _save_npz(outdir / "io.npz", x=x, y=_forward_fp32(model, x, dev))


def check(fam: str, indir: Optional[Path] = None, device=None) -> float:
    """Import the checkpoint of `indir/fam` (the committed goldens unless
    given another root, such as one `make` wrote), forward its pinned input
    on `device` (the card unless the caller asks for the CPU), assert its
    saved output. Returns the max abs deviation."""
    dev = device_lib.resolve(device)
    cfg = GOLDEN_CFGS[fam]
    d = (indir or golden_dir()) / fam
    params = tfc.import_checkpoint(d / "model.ckpt", cfg)
    model = factory.build_model(cfg)
    weights_io.load_into(model, params)
    model.to(dev).eval()
    with np.load(d / "io.npz") as f:
        x, y_ref = f["x"], f["y"]
    y = _forward_fp32(model, x, dev)
    dev_abs = float(np.max(np.abs(y - y_ref)))
    if not dev_abs <= ATOL:
        raise AssertionError(
            f"{fam}: golden forward-output deviation {dev_abs:.3e} > {ATOL} — "
            "the TF name map, conv lowering, or model semantics changed "
            "relative to the committed artifacts"
        )
    return dev_abs
