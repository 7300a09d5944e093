"""Build and load a CUDA source of the port as a shared library.

Each source in ``csrc/`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` at first use, under ``build/repro_torch_kernels/``
at the root of the checkout, and loaded with ``ctypes``. The library's name
carries a hash of the source and the flags, so an edited source is rebuilt
and a built one is reused. A build writes a temporary file and renames it
into place, so a concurrent build never loads half a library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def library_path(src: Path) -> Path:
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME")


def build(src: Path, verbose: bool = False) -> tuple[Path, str]:
    """Compile ``src`` unless this source is built already.

    Returns the library's path and the compiler's messages (``verbose``
    adds ``-Xptxas -v``: registers, shared memory and spills per kernel;
    empty when the library was already built). Raises if nvcc fails."""
    out = library_path(src)
    if out.exists():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)          # atomic: a concurrent build never sees half
    return out, proc.stdout + proc.stderr


def load(src: Path) -> ctypes.CDLL:
    """Build ``src`` if needed and load the library; the caller declares
    each function's ``argtypes`` and ``restype``."""
    path, _ = build(src)
    return ctypes.CDLL(str(path))
