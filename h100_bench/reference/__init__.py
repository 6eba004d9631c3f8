"""The plain references that decide `correct`: plain PyTorch and numpy,
importing nothing of the program (deepdenoiser_tpu_torch) and nothing of
JAX. `frame` and `train` hold the frame pipeline and the training step;
one module per architecture (named by a configuration's bench.reference)
holds the network, and is the one place that describes the architecture
to the harness (registry.ARCHITECTURE; registry.validate reports a module
that lacks one):

  load_params(path)           the weights file as {flat Flax path: fp32 array}
  to_device(flat, device)     those as fp32 tensors on the device
  network(p, x, model, f8)    the forward, (N,H,W,Cin) -> (N,H,W,Cout) fp32,
                              f8: every conv operand rounded to float8
  halo(model)                 the certified one-sided receptive field, pixels
  multiple(model)             the size the network's plane divides
  count_backbone(net, n, h, w, cin, cout, prefix)
                              the backbone's rows of counts.py under the head,
                              through counts._Net's conv_block, concat,
                              upsample and head (or its unet and tiramisu),
                              by counts.py's rules of FLOPs and bytes
  param_shapes(model)         {flat Flax path: shape} of a seeded weights
                              file (seeded.py draws them)

A new backbone is a new module here with these, a configuration naming it,
and its cell's files; no file of the harness changes."""

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
