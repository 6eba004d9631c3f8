"""Parallelism layer of the port: a single-controller device mesh with
band-parallel frames (halo exchange) and frame-batch data parallelism for
inference, and data-parallel training ranks over torch.distributed.

The port of deepdenoiser_tpu/parallel. The JAX package runs one program
over a Mesh through shard_map, with ppermute for the halo exchange and
pmean for the gradient all-reduce. Here inference stays in one process
that drives every device of a `mesh.Mesh` (halo.py: the exchange is a
device-to-device copy), and training runs one process per rank (dist.py:
the all-reduce is torch.distributed's).
"""
