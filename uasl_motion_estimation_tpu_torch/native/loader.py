"""ctypes bridge to the C++ async frame loader (frame_loader.cpp).

The port's copy of ``uasl_motion_estimation_tpu/native/loader.py``. The
loader decodes PNG frames in a background C++ thread into a bounded queue,
overlapping disk and decode with the card's compute: the asynchronous
upgrade of the reference's synchronous ImageReader (file_IO.h:300-421).
``utils.io.ImageSequenceReader`` is the pure-Python reader beside it.

The library is built from ``frame_loader.cpp`` with g++ and OpenCV's
headers at first use, into the package's git-ignored ``_build/``; its name
carries a hash of the source and the command, so an edited source is
rebuilt. Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "frame_loader.cpp"
BUILD_DIR = _HERE.parent / "_build"
_lib = None


def _command() -> list[str]:
    """g++ flags for the library (OpenCV's include path from pkg-config)."""
    cflags = subprocess.run(["pkg-config", "--cflags", "opencv4"], capture_output=True,
                            text=True, check=True, timeout=60).stdout.split()
    return ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", *cflags,
            "-lopencv_core", "-lopencv_imgcodecs"]


def library_path() -> Path:
    """Where the library of the current source and command is built."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(_command()).encode())
    return BUILD_DIR / f"frameloader-{digest.hexdigest()[:16]}.so"


def build_native(force: bool = False) -> bool:
    """Compile the shared library (needs g++ and OpenCV's headers); False
    where it cannot be built."""
    try:
        lib = library_path()
        if lib.exists() and not force:
            return True
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = _command()
        subprocess.run([*cmd[:-2], str(SOURCE), *cmd[-2:], "-o", str(tmp)], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not build_native():
        return None
    lib = ctypes.CDLL(str(library_path()))
    lib.fl_open.restype = ctypes.c_void_p
    lib.fl_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.fl_dims.restype = ctypes.c_int
    lib.fl_dims.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_int)]
    lib.fl_next.restype = ctypes.c_int
    lib.fl_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.fl_close.restype = None
    lib.fl_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_lib() is not None


class AsyncFrameLoader:
    """Iterate (index, left, right) float32 frames with background decode.

    Usage:
        with AsyncFrameLoader(dir, kitti=True) as fl:
            for idx, left, right in fl: ...
    """

    def __init__(self, directory: str, start: int = 0, stop: int = -1,
                 skip: int = 1, kitti: bool = True, kitti_crop: int = 374,
                 appendix: str = "", stereo: bool = True,
                 queue_depth: int = 4):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(
                "native frame loader cannot be built (needs g++ and OpenCV's "
                "headers); use utils.io.ImageSequenceReader instead"
            )
        self._lib = lib
        self._stereo = stereo
        self._h = lib.fl_open(
            directory.encode(), start, stop, skip, int(kitti), kitti_crop,
            appendix.encode(), int(stereo), queue_depth,
        )
        self._shape: tuple[int, int] | None = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _dims(self) -> tuple[int, int] | None:
        h = ctypes.c_int()
        w = ctypes.c_int()
        if not self._lib.fl_dims(self._h, ctypes.byref(h), ctypes.byref(w)):
            return None
        return h.value, w.value

    def __iter__(self):
        while True:
            dims = self._dims()
            if dims is None:
                return
            h, w = dims
            left = np.empty((h, w), np.float32)
            right = np.empty((h, w), np.float32) if self._stereo else None
            idx = self._lib.fl_next(
                self._h,
                left.ctypes.data_as(ctypes.c_void_p),
                right.ctypes.data_as(ctypes.c_void_p)
                if right is not None else None,
            )
            if idx < 0:
                return
            yield (idx, left, right) if self._stereo else (idx, left)

    def close(self):
        if self._h:
            self._lib.fl_close(self._h)
            self._h = None
