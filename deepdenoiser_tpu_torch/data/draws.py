"""The draw source of the on-device generators (data/mc_tracer.py,
data/synthetic_device.py).

The JAX package draws with `jax.random` (threefry keys split and folded
per sample), which `torch.Generator` cannot reproduce, and a CUDA
generator draws another stream than a CPU one. So the port's generators
take every random number from a draw source with three methods:

    uniform(shape, lo, hi)  lo + (hi - lo) * U, U uniform on [0, 1)
    normal(shape)           standard normal
    randint(shape, lo, hi)  integers in [lo, hi)

`Draws` backs them with one `torch.Generator` and makes every tensor on
the generator's device. The tests hand the generators a source that
replays the numbers the JAX functions drew, in the order they drew them,
so both packages compute the same function on the same numbers.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from deepdenoiser_tpu_torch import device as device_lib

Tensor = torch.Tensor
Shape = Sequence[int]


class Draws:
    """Random draws from `generator`, on its device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def uniform(self, shape: Shape, lo: float = 0.0, hi: float = 1.0) -> Tensor:
        u = torch.rand(tuple(shape), generator=self.generator, device=self.device)
        return lo + (hi - lo) * u

    def normal(self, shape: Shape) -> Tensor:
        return torch.randn(tuple(shape), generator=self.generator, device=self.device)

    def randint(self, shape: Shape, lo: int, hi: int) -> Tensor:
        return torch.randint(lo, hi, tuple(shape), generator=self.generator, device=self.device)


def seeded(seed: Union[int, Sequence[int]],
           device: Optional[Union[str, torch.device]] = None) -> Draws:
    """A draw source on `device` (the card unless the caller asks for the
    CPU) whose generator is seeded from `seed`, an int or a tuple of ints
    mixed into one 64-bit seed (numpy's SeedSequence: distinct tuples give
    unrelated streams, as jax.random.fold_in does for keys)."""
    dev = device_lib.resolve(device)
    parts = [seed] if isinstance(seed, int) else list(seed)
    mixed = int(np.random.SeedSequence(parts).generate_state(1, np.uint64)[0])
    return Draws(torch.Generator(device=dev).manual_seed(mixed))
