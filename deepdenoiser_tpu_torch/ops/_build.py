"""Build the port's native sources at first use, and load them.

Each `csrc/<name>.cu` is compiled on its own with nvcc into a shared
library with a plain C interface, loaded with ctypes (no PyTorch headers,
so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/<name>-<hash>.so

Each `csrc/<name>.cpp` is host C++ (the EXR codec's byte predictor,
data/_native.py), built the same way by the host compiler, c++ or g++,
with native/Makefile's flags: `-O3 -fPIC -shared -std=c++17`.

The output goes to build/torch_kernels/ at the repository root (listed in
.gitignore), keyed by a hash of the sources and flags, so an edited source
rebuilds. `build()` starts one compiler per missing library, all
together, and waits for them; each writes to a name of its own process
and is renamed into place, so processes that build at once (test workers)
never load a half-written library. A failed build raises with the
compiler's output. The ptxas report (registers, shared memory, spills) is
kept beside each CUDA library.

Nothing here runs at import: the CPU tests import every module, and nvcc
is needed only when a kernel is first launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every CUDA kernel source under csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _source(name: str) -> Path:
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def _flags(src: Path) -> tuple:
    return NVCC_FLAGS if src.suffix == ".cu" else HOST_FLAGS


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (no CUDA toolkit on PATH or CUDA_HOME)")


def _cxx() -> str:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ or g++) on PATH")


def library_path(name: str) -> Path:
    src = _source(name)
    h = hashlib.sha256()
    for p in [src, *(sorted(CSRC.glob("*.cuh")) if src.suffix == ".cu" else ())]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(_flags(src)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every named source (default: every CUDA source) that has no
    up-to-date library, one compiler each, all started together. Returns
    name -> path."""
    names = list(names) if names is not None else sources()
    targets = {n: library_path(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n, t in todo.items():
            tmp = t.with_suffix(f".{os.getpid()}.tmp.so")
            src = _source(n)
            compiler = _nvcc() if src.suffix == ".cu" else _cxx()
            cmd = [compiler, *_flags(src), "-o", str(tmp), str(src)]
            procs[n] = (tmp, compiler, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        failed = []
        for n, (tmp, compiler, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{Path(compiler).name} failed for csrc/{_source(n).name} "
                              f"(rc {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
                continue
            todo[n].with_suffix(".log").write_text(log)
            os.replace(tmp, todo[n])  # atomic: a racing process sees all or nothing
        if failed:
            raise RuntimeError("\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = build([name])[name]
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib
