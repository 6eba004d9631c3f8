"""Device meshes for the single-controller parallel modes.

Axis conventions, as in the JAX package:
  'data'    — frame-batch sharding (inference/sequence.make_batch_frame_denoiser)
  'spatial' — frame-row bands with halo exchange (parallel/halo.py)

A Mesh is an array of torch devices with named axes; one process drives
all of them. A device may be listed more than once: the tests pass
["cpu"] * 8, as the JAX tests list 8 fake CPU devices, and on a machine
with one card ["cuda:0"] * 4 runs every band or chunk of a 4-way mesh on
that card, one after another.

The JAX module's `replicated` and `batch_sharded` shardings have no
counterpart: nothing is placed by a sharding here. Model replicas are made
where a device first needs one (halo.py, sequence.py), and `shard_batch`
hands each device its chunk.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from deepdenoiser_tpu_torch import device as device_lib

DeviceLike = Union[str, torch.device]


def _device(d: DeviceLike) -> torch.device:
    dev = device_lib.resolve(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """`devices`: an array of torch devices whose dimensions are the named
    axes; `shape[axis]` is the size of one axis."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-D devices for axes {tuple(axis_names)}")
        self.devices = np.vectorize(_device, otypes=[object])(arr)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along `axis`, at index 0 of every other axis."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no {axis!r} axis")
        k = self.axis_names.index(axis)
        return list(np.moveaxis(self.devices, k, 0).reshape(self.devices.shape[k], -1)[:, 0])


def _visible(devices: Optional[Sequence[DeviceLike]]) -> List[DeviceLike]:
    if devices is not None:
        return list(devices)
    device_lib.resolve("cuda")  # raises when there is no card
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """1-D mesh over the first n_devices of `devices` (default: every
    visible card)."""
    devs = _visible(devices)
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"want {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(devs, (axis_name,))


def make_mesh_2d(n_data: int, n_spatial: int,
                 devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """('data', 'spatial') mesh: frame batches x row bands."""
    devs = _visible(devices)
    need = n_data * n_spatial
    if need > len(devs):
        raise ValueError(f"want {need} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:need], dtype=object).reshape(n_data, n_spatial),
                ("data", "spatial"))


def shard_batch(batch: Dict[str, Any], mesh: Mesh, axis_name: str = "data"
                ) -> List[Dict[str, torch.Tensor]]:
    """Split a batch dict's leading axis into one chunk per device along
    `axis_name`, each chunk on its device. The leading axis must divide by
    the axis size."""
    devs = mesh.axis_devices(axis_name)
    n = len(devs)
    out: List[Dict[str, torch.Tensor]] = [{} for _ in devs]
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if t.shape[0] % n:
            raise ValueError(f"{k}: leading axis {t.shape[0]} not divisible by {n} devices")
        for chunk, d, dst in zip(t.chunk(n), devs, out):
            dst[k] = chunk.to(d)
    return out
