"""Build a CUDA source of ``csrc/`` into a shared library with nvcc.

Each source is compiled on its own into ``_build/`` inside the package (a
directory git ignores), at first use, for ``sm_90a``, and loaded with ctypes
by the kernel's wrapper. The file name carries a hash of the source and
flags, so an edited source is rebuilt and a stale library never loads.
Nothing here runs at import time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else the CUDA toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: building a CUDA kernel needs the CUDA toolkit")


def build_library(source: str | Path) -> Path:
    """Compile ``csrc/<source>``, or the file ``source`` where it is an
    absolute path (another checkout's kernel), unless already built, and
    return the path of the shared library. The compiler's output, register
    and shared memory use included, is kept beside it as ``<library>.log``."""
    src = CSRC / source  # an absolute ``source`` replaces CSRC
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}{proc.stderr}")
    Path(f"{lib}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib
