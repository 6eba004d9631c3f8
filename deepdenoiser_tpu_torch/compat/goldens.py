"""The frozen TF-checkpoint goldens, checked by the port.

The JAX package pins one set of artifacts per zoo family on disk
(deepdenoiser_tpu/compat/goldens.py):

    tests/goldens/tf_compat/<fam>/model.ckpt.*   frozen TF1 checkpoint
    tests/goldens/tf_compat/<fam>/io.npz         pinned input x, fp32 output y

`check()` imports the frozen checkpoint through compat/tf_checkpoint.py,
carries it into the port's model and forwards the pinned input on the
given device: the output must match the frozen one within ATOL. On the
card the forward runs in full fp32 (TF32 off for cuDNN and matmuls), as
the goldens were made; the `kpn` family launches the KPN filter apply
(k=3) once per slot, twice. The artifacts are the JAX package's and are
never rewritten here: there is no `make`.
"""

from __future__ import annotations

import contextlib
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


def check(fam: str, indir: Optional[Path] = None, device=None) -> float:
    """Import the frozen checkpoint, forward the pinned input on `device`
    (the card unless the caller asks for the CPU), assert the frozen
    output. Returns the max abs deviation."""
    dev = device_lib.resolve(device)
    cfg = GOLDEN_CFGS[fam]
    d = (indir or golden_dir()) / fam
    params = tfc.import_checkpoint(d / "model.ckpt", cfg)
    model = factory.build_model(cfg)
    weights_io.load_into(model, params)
    model.to(dev).eval()
    with np.load(d / "io.npz") as io:
        x, y_ref = io["x"], io["y"]
    with torch.no_grad(), _full_fp32():
        y = model(torch.from_numpy(x).to(dev)).float().cpu().numpy()
    dev_abs = float(np.max(np.abs(y - y_ref)))
    if not dev_abs <= ATOL:
        raise AssertionError(
            f"{fam}: golden forward-output deviation {dev_abs:.3e} > {ATOL} — "
            "the TF name map, conv lowering, or model semantics changed "
            "relative to the committed artifacts"
        )
    return dev_abs
