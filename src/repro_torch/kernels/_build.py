"""Build the kernels' CUDA sources into shared libraries and load them.

Each family's ``csrc/*.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), loaded with ``ctypes``.  Libraries go to ``build/torch_kernels/``
at the root of the checkout, named by a hash of the source and the flags,
so an edited source rebuilds and an unchanged one is reused.  A missing
``nvcc`` or a failed build raises :class:`~repro_torch.kernels.KernelError`:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Iterable, Optional

from repro_torch.kernels import KernelError

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "torch_kernels"

#: family name -> its CUDA source, relative to this package.
SOURCES = {
    "fedavg": "fedavg/csrc/fedavg.cu",
    "quantize": "quantize/csrc/quantize.cu",
    "topk": "topk/csrc/topk.cu",
    "checksum": "checksum/csrc/checksum.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the CUDA kernels cannot "
                           "be built")
    return path


def library_path(name: str) -> Path:
    """Where ``name``'s library lives for the current source and flags."""
    src = (_PKG / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> dict[str, float]:
    """Compile every family in ``names`` (default: all) whose library is
    missing, one ``nvcc`` per source, all started together.  Returns the
    wall seconds each build took (0.0 for a library already built).  The
    compiler's output, register counts included, goes to
    ``build/torch_kernels/<name>.log``."""
    names = list(SOURCES if names is None else names)
    out = {name: 0.0 for name in names}
    todo = [name for name in names if not library_path(name).exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    try:
        for name in todo:
            target = library_path(name)
            tmp = target.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(_PKG / SOURCES[name])]
            with open(BUILD_DIR / f"{name}.log", "w") as log:
                proc = subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT)
            procs.append((name, target, tmp, time.perf_counter(), proc))
    finally:
        # Wait for every compiler started, even if a later start failed.
        for name, _, _, t0, proc in procs:
            proc.wait()
            out[name] = time.perf_counter() - t0
    failed = []
    for name, target, tmp, _, proc in procs:
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n"
                          + (BUILD_DIR / f"{name}.log").read_text())
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise KernelError("CUDA kernel build failed: " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of family ``name``, building it first if needed.
    Every library exports ``<name>_error_string(int) -> const char*``."""
    lib = _LIBS.get(name)
    if lib is None:
        target = library_path(name)
        if not target.exists():
            build([name])
        lib = ctypes.CDLL(str(target))
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(rc: int, name: str, what: str) -> None:
    """Raise if the C launcher ``what`` of family ``name`` returned a
    nonzero ``cudaError_t`` (a refused launch never runs, and a later
    synchronize would not report it)."""
    if rc != 0:
        msg = getattr(_LIBS[name], f"{name}_error_string")(rc)
        raise KernelError(f"{what} launch failed: cudaError_t {rc} "
                           f"({msg.decode(errors='replace')})")
