"""The JAX package's numpy-only helpers, loaded by file path.

``utils/synthetic.py`` and ``utils/metrics.py`` of ``uasl_motion_estimation_tpu``
import only numpy and the standard library, so the port shares one copy of
each. They cannot be imported the normal way: importing any submodule runs
``uasl_motion_estimation_tpu/__init__.py``, which imports ``ops`` and with it
``jax`` (absent where the port runs). Loading the files directly skips that
``__init__``.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_UTILS = Path(__file__).resolve().parent.parent / "uasl_motion_estimation_tpu" / "utils"


def _load(name: str):
    mod_name = f"{__name__}.{name}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, _UTILS / f"{name}.py")
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {name}.py from {_UTILS}")
    mod = importlib.util.module_from_spec(spec)
    # registered before exec so NamedTuples defined there pickle by name
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


synthetic = _load("synthetic")
metrics = _load("metrics")
