"""Native host runtime of the port: C++ components bridged with ctypes,
built with g++ at first use (the port's copy of the JAX package's
``native/``)."""

from .loader import AsyncFrameLoader, build_native, native_available  # noqa: F401
