"""The benchmark's own instrumentation: wrappers around the port's module
functions, installed from here and only for the run that needs them.

- ``patch(module, name, wrapper)`` replaces ``module.name`` and returns an
  undo; the port's callers look the name up at call time, so they reach
  the wrapper.
- ``Capture`` keeps what wrapped functions returned in the one pass the
  comparison will judge, and a small tally of every pass.
- ``fenced_span`` times a call as a profiler range between two device
  synchronisations (traced runs only).
- ``count_syncs`` counts stream synchronisations with torch's sync debug
  mode.
"""

from __future__ import annotations

import functools
import warnings
from typing import Callable

import numpy as np
import torch


def patch(module, name: str, make: Callable[[Callable], Callable]) -> Callable[[], None]:
    """Replace ``module.name`` by ``make(original)``; returns the undo."""
    original = getattr(module, name)
    setattr(module, name, functools.wraps(original)(make(original)))
    return lambda: setattr(module, name, original)


def pass_rng(seed: int) -> np.random.Generator:
    """The draws that pick the judged pass, from the run's seed."""
    return np.random.default_rng(np.random.SeedSequence(seed, spawn_key=(7,)))


class Capture:
    """What wrapped functions returned, kept for after the window.

    One pass is kept whole: the one the comparison judges, drawn uniformly
    among the passes started with ``start_pass`` by a reservoir pick of one
    from ``pass_rng(seed)`` (the count is known only when the window
    closes). The pick is made as a pass starts, so a pass that will not be
    judged keeps nothing whole, and the one kept before it is dropped as
    the new one starts. From every pass, each wrapper's ``tally`` (the flags
    and counts the engine reads over all passes) is kept as tensors of their
    own: a view would keep its whole storage alive. Nothing here reads the
    device."""

    def __init__(self, seed: int):
        self.rng = pass_rng(seed)
        self.on = True
        self.n = 0  # passes started
        self.judged: dict | None = None  # the whole capture of the judged pass
        self.judged_index: int | None = None
        self.tallies: list[dict] = []  # per pass, {key: [tuple of tensors]}
        self.full: dict | None = None  # the running pass's capture, where it is the judged one

    def start_pass(self) -> None:
        self.full = None
        if self.rng.integers(self.n + 1) == 0:
            self.judged = self.full = {}
            self.judged_index = self.n
        self.tallies.append({})
        self.n += 1

    def wrap(self, key: str, pick: Callable | None = None,
             tally: Callable | None = None) -> Callable[[Callable], Callable]:
        def make(fn):
            def wrapper(*args, **kwargs):
                out = fn(*args, **kwargs)
                if self.on and self.tallies:
                    if self.full is not None:
                        self.full.setdefault(key, []).append(pick(out) if pick else out)
                    if tally is not None:
                        self.tallies[-1].setdefault(key, []).append(
                            tuple(t.clone() for t in tally(out)))
                return out
            return wrapper
        return make

    def tallied(self, key: str, k: int = 0) -> list:
        """Item ``k`` of every tally under ``key``, over every pass."""
        return [t[k] for p in self.tallies for t in p.get(key, [])]


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
