"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each `csrc/<name>.cu` has a plain C interface and is compiled at first use
into `build/kernels/` at the checkout's root (listed in `.gitignore`), under
a file name that carries a hash of the source, of every shared header
(`csrc/*.cuh`) and of the flags, so an edited source or header never loads
a stale library. A verbose build keeps ptxas's report
(registers, stack and spills of every kernel variant) beside the library
(`report_path`). Nothing is fetched: the build needs only the CUDA
toolkit's `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    """`nvcc` from the CUDA toolkit PyTorch was built against, else PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def report_path(name: str) -> pathlib.Path:
    """Where a verbose build keeps ptxas's report for this source."""
    return library_path(name).with_suffix(".ptxas.txt")


def build(name: str, verbose: bool = False) -> pathlib.Path:
    """Compile `csrc/<name>.cu` unless the library for this source exists
    (and, with `verbose`, its ptxas report)."""
    out = library_path(name)
    if out.exists() and (not verbose or report_path(name).exists()):
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    if verbose:
        report_path(name).write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, once per process."""
    return ctypes.CDLL(str(build(name)))
