"""The plain references that decide `correct`: plain PyTorch and numpy,
importing nothing of the program (deepdenoiser_tpu_torch) and nothing of
JAX. `frame` and `train` hold the frame pipeline and the training step;
one module per architecture (named by a configuration's bench.reference)
holds the network."""

import torch


class no_tf32:
    """TF32 off for float32 convolutions and matrix products while open."""

    def __enter__(self):
        self.prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.prev
        return False
