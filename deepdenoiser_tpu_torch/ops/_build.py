"""Build the port's CUDA sources with nvcc at first use, and load them.

Each `csrc/<name>.cu` is compiled on its own into a shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/<name>-<hash>.so

The output goes to build/torch_kernels/ at the repository root (listed in
.gitignore), keyed by a hash of the sources and flags, so an edited source
rebuilds. `build()` starts one nvcc per missing source, all together, and
waits for them; a failed build raises with nvcc's output. The ptxas report
(registers, shared memory, spills) is kept beside each library.

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

_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every kernel source under csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (no CUDA toolkit on PATH or CUDA_HOME)")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every named source (default: all) that has no up-to-date
    library, one nvcc each, all started together. Returns name -> path."""
    names = list(names) if names is not None else sources()
    targets = {n: library_path(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n, t in todo.items():
            tmp = t.with_suffix(f".{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        failed = []
        for n, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed for csrc/{n}.cu (rc {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
                continue
            todo[n].with_suffix(".log").write_text(log)
            os.replace(tmp, todo[n])  # atomic: a racing process sees all or nothing
        if failed:
            raise RuntimeError("\n".join(failed))
    return targets


def ptxas_report(name: str) -> str:
    """The ptxas lines (registers, shared memory, spills) of a built source."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return ""
    return "\n".join(
        ln for ln in log.read_text().splitlines() if "ptxas" in ln or "spill" in ln
    )


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = build([name])[name]
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib
