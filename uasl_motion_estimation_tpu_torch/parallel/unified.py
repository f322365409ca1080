"""Window parallelism across ranks for the unified track-table engine.

Port of ``uasl_motion_estimation_tpu/parallel/unified.py``. The integrated
system (models/smoother.py) makes sliding windows its unit of work: each
window's detection, tracking, per-motion VO and BA are independent of every
other window's. So the windows shard over the ranks with no collective in
the compute path; the only coupling, the host's best-support motion
install (``compose_unified``), reads the gathered per-window outputs.

Each rank uploads only the frames its windows touch: window spans are
contiguous, so a rank's working set is (g - 1) * stride + window frames
whatever the sequence's length.
"""

from __future__ import annotations

import numpy as np

from ..models.pipeline import Sampler
from ..models.smoother import (SmootherConfig, UnifiedOutput, _check_stride, _unpack,
                               unified_solve_group, unified_window_starts)
from .launch import Mesh, all_gather
from .segments import _to_device


def sharded_unified_scan(ls, rs, sampler: Sampler, cfg: SmootherConfig, mesh: Mesh
                         ) -> UnifiedOutput:
    """The whole integrated system with the window axis sharded over the
    ranks: each rank builds the track tables, solves the VO and runs BA of
    its own windows (one group), then the packed outputs are gathered.

    ``ls``, ``rs`` (n, H, W): the whole staged sequence on the host (numpy,
    a memory map too) or a tensor, uint8 or float32; each rank copies the
    span its windows touch to its device. The window starts are padded to a
    multiple of the mesh size by repeating the last one, and the padding is
    dropped after the gather. Samples of motion i come from ``sampler(i,
    valid)`` (global index). Returns every window's outputs, on every rank,
    as ``unified_system_scan`` does (``compose_unified`` composes them)."""
    _check_stride(cfg)
    n = int(ls.shape[0])
    starts = unified_window_starts(n, cfg.window, cfg.ba_rate)
    k = len(starts)
    if k == 0:
        raise ValueError(f"sequence of {n} frames has no windows")
    g = -(-k // mesh.size)
    padded = np.concatenate([starts, np.full(g * mesh.size - k, starts[-1], np.int32)])
    local = padded[mesh.rank * g:(mesh.rank + 1) * g]
    lo, hi = int(local[0]), int(local[-1]) + cfg.window
    lf = _to_device(ls[lo:hi], mesh.device).float()
    rf = _to_device(rs[lo:hi], mesh.device).float()
    packed = unified_solve_group(lf, rf, local - lo, sampler, lo, cfg)  # (g, F)
    rows = all_gather(mesh, packed).reshape(g * mesh.size, -1)[:k]
    return _unpack(rows.cpu().numpy(), cfg.window)
