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

This slice: the joint-mode whole-frame denoise
(inference.pipeline.make_joint_frame_denoiser) for the kpn-hq,
flagship-hq and flagship-mc presets, with the KPN filter apply as a CUDA
kernel (ops/kpn_apply.py, csrc/kpn_apply.cu).
"""

__version__ = "0.1.0"
