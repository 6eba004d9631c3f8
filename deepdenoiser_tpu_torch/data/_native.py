"""ctypes bindings of the EXR codec's native byte predictor
(csrc/exr_pack.cpp), the port of deepdenoiser_tpu/data/_native.py.

The JAX package loads native/libexr_pack.so when someone has built it and
otherwise falls back to numpy. Here the library is built from the port's
own source at first use (ops/_build.py, the host compiler, into
build/torch_kernels/) and always used: a failed build raises with the
compiler's output, and nothing slips back to numpy. The numpy versions
stay in exr_codec.py as the plain versions the tests compare with, bit for
bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from deepdenoiser_tpu_torch.ops import _build

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("exr_pack")
        for fn in (lib.exr_split_and_predict, lib.exr_unpredict_and_merge):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
            fn.restype = None
        _lib = lib
    return _lib


def available() -> bool:
    """True once the library is built and loaded (building it if needed);
    a failed build raises."""
    return _load() is not None


def _run(fn_name: str, data: bytes) -> bytes:
    # np.frombuffer views the bytes without a copy; the C function only
    # reads them, and `src` keeps them alive for the call
    src = np.frombuffer(data, dtype=np.uint8)
    dst = np.empty(len(src), dtype=np.uint8)
    getattr(_load(), fn_name)(src.ctypes.data, dst.ctypes.data, len(src))
    return dst.tobytes()


def split_and_predict(data: bytes) -> bytes:
    """OpenEXR ZIP preprocessing: interleave-split, then the byte delta."""
    return _run("exr_split_and_predict", data)


def unpredict_and_merge(data: bytes) -> bytes:
    """Inverse of split_and_predict."""
    return _run("exr_unpredict_and_merge", data)
