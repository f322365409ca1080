"""The benchmark's own instrumentation: wrappers around the port's module
functions, installed from here and only for the run that needs them.

- ``patch(module, name, wrapper)`` replaces ``module.name`` and returns an
  undo; the port's callers look the name up at call time, so they reach
  the wrapper.
- ``Capture`` keeps what a wrapped function returned during the current
  pass (the comparison judges it after the window).
- ``fenced_span`` times a call as a profiler range between two device
  synchronisations (traced runs only).
- ``count_syncs`` counts stream synchronisations with torch's sync debug
  mode.
"""

from __future__ import annotations

import functools
import warnings
from typing import Callable

import torch


def patch(module, name: str, make: Callable[[Callable], Callable]) -> Callable[[], None]:
    """Replace ``module.name`` by ``make(original)``; returns the undo."""
    original = getattr(module, name)
    setattr(module, name, functools.wraps(original)(make(original)))
    return lambda: setattr(module, name, original)


class Capture:
    """Per-pass lists of what wrapped functions returned."""

    def __init__(self):
        self.passes: list[dict] = []
        self.on = True

    def start_pass(self) -> None:
        self.passes.append({})

    def wrap(self, key: str, pick: Callable | None = None) -> Callable[[Callable], Callable]:
        def make(fn):
            def wrapper(*args, **kwargs):
                out = fn(*args, **kwargs)
                if self.on and self.passes:
                    self.passes[-1].setdefault(key, []).append(pick(out) if pick else out)
                return out
            return wrapper
        return make


def fenced_span(name: str) -> Callable[[Callable], Callable]:
    """Wrap a function in a profiler range named ``name``, fenced by a
    device synchronisation on each side so its time is its own."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)

    def make(fn):
        def wrapper(*args, **kwargs):
            sync()
            with torch.profiler.record_function(f"span:{name}"):
                out = fn(*args, **kwargs)
                sync()
            return out
        return wrapper
    return make


def count_syncs(fn: Callable[[], object]) -> int:
    """Stream synchronisations that ``fn`` makes (host reads of device
    values), counted with torch's sync debug mode."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)
