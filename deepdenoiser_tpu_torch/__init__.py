"""deepdenoiser_tpu_torch — the PyTorch/CUDA port of deepdenoiser_tpu.

A second package beside the JAX one, written for one NVIDIA H100. Module
names mirror deepdenoiser_tpu so each counterpart is easy to find; the
JAX package stays the reference the port is tested against
(tests/test_torch_*.py). The port imports torch and numpy only — never
jax, flax or anything of deepdenoiser_tpu.

Every Pallas kernel on a ported path becomes a CUDA C++ kernel for
sm_90a under csrc/, built with nvcc at first use (ops/_build.py). Entry
points run on the card unless the caller passes device="cpu"; on CPU
tensors each kernel wrapper runs its plain PyTorch version.

Ported so far: everything the JAX package does to denoise on one device —
joint, group and rgb frame denoisers (inference/pipeline.py), whole-frame
or tiled (inference/tiled.py), every preset's model (UNet, tiramisu,
multi-scale, KPN head), PSNR/SSIM/MS-SSIM, the sequence harness
(inference/sequence.py) and the `denoise` and `eval` commands; with the
KPN filter apply (ops/kpn_apply.py) and the fused ingest
(ops/fused_ingest.py) as CUDA kernels.
"""

__version__ = "0.1.0"
