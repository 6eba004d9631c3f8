"""Replay of jax.random draws for the port's generators (a helper of the
tests/test_torch_* files; pytest does not collect it).

`record(monkeypatch)` wraps jax.random.uniform, normal and randint so that
every call made while a JAX function runs eagerly (not jitted, or under
jax.disable_jit()) appends (kind, value, arguments) to the returned list.
`Replay(records)` is a draw source for the port (data/draws.py) that hands
those values back in order, checking that the port asks for the same kind
of draw, the same number of values and the same range at every step.
"""

import inspect
import math

import jax
import numpy as np
import torch


def record(monkeypatch) -> list:
    records = []

    def wrap(kind, fn):
        sig = inspect.signature(fn)

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            records.append((kind, np.asarray(out), dict(bound.arguments)))
            return out

        return wrapped

    for kind in ("uniform", "normal", "randint"):
        monkeypatch.setattr(jax.random, kind, wrap(kind, getattr(jax.random, kind)))
    return records


class Replay:
    """A draw source that replays recorded JAX draws on `device`."""

    def __init__(self, records, device="cpu"):
        self.records = list(records)
        self.device = torch.device(device)
        self.used = 0

    def _next(self, kind, shape):
        assert self.used < len(self.records), f"the port draws more than JAX ({kind} {shape})"
        got, value, args = self.records[self.used]
        self.used += 1
        assert got == kind, (self.used, got, kind)
        assert value.size == math.prod(shape), (self.used, kind, value.shape, shape)
        return value.reshape(tuple(shape)), args

    def _check_range(self, args, lo, hi):
        assert math.isclose(float(args["minval"]), lo, rel_tol=1e-12, abs_tol=1e-12), (args, lo)
        assert math.isclose(float(args["maxval"]), hi, rel_tol=1e-12, abs_tol=1e-12), (args, hi)

    def uniform(self, shape, lo=0.0, hi=1.0):
        value, args = self._next("uniform", shape)
        self._check_range(args, lo, hi)
        return torch.from_numpy(np.array(value, np.float32)).to(self.device)

    def normal(self, shape):
        value, _ = self._next("normal", shape)
        return torch.from_numpy(np.array(value, np.float32)).to(self.device)

    def randint(self, shape, lo, hi):
        value, args = self._next("randint", shape)
        self._check_range(args, lo, hi)
        return torch.from_numpy(np.array(value, np.int64)).to(self.device)

    @property
    def exhausted(self) -> bool:
        return self.used == len(self.records)
