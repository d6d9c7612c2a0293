"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  Libraries
go to ``build/repro_torch_kernels/`` at the repository root, named by a hash
of the source, the shared headers and the compiler flags, so a fresh
checkout builds them at first use and an edited ``.cu`` or ``.cuh``
rebuilds.  :func:`build` starts one ``nvcc`` per missing library, all at
once.  A missing ``nvcc`` or a failed build raises; nothing here falls
back.  Nothing runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def kernel_names() -> List[str]:
    """Every kernel source in ``csrc/``, by stem."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    """Where the library for the current ``csrc/<name>.cu`` (and the shared
    ``csrc/*.cuh`` headers it may include) lives."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError(
            "nvcc not found: the CUDA kernels need the CUDA toolkit "
            "(set CUDA_HOME or put nvcc on PATH)")
    return str(nvcc)


def build(names: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    """Compile every kernel in ``names`` (default: all) whose library is
    missing, one ``nvcc`` process each, all started together.  Returns
    ``{name: {"path", "seconds", "built", "log"}}`` where ``log`` holds what
    ``-Xptxas -v`` printed (registers, spills) for a fresh build."""
    names = kernel_names() if names is None else list(names)
    out: Dict[str, dict] = {}
    running = []
    for name in names:
        lib = library_path(name)
        if lib.exists():
            out[name] = {"path": str(lib), "seconds": 0.0, "built": False,
                         "log": ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, lib, tmp, proc, time.perf_counter()))
    failures = []
    for name, lib, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (exit "
                            f"{proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)   # atomic: a concurrent loader never sees half a file
        out[name] = {"path": str(lib), "seconds": seconds, "built": True,
                     "log": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if its
    current source has no library yet."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
