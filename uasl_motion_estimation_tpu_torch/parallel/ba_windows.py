"""Window-parallel BA across ranks, with a fixed-frame halo exchange.

Port of ``uasl_motion_estimation_tpu/parallel/ba_windows.py``. Consecutive
BA windows overlap by ``n_fixed`` frames (window i's last ``n_fixed``
frames are window i+1's first), and every window holds its first
``n_fixed`` frames fixed (the reference's SetParameterBlockConstant,
BundleAdjuster.h:406-407,452-453). All windows solve at once, each rank its
k windows as one batch of ``ba_solve``; after each solve, every window's
refined tail becomes its right neighbour's fixed head: a shift by one
window inside the rank, and one send of the rank's last tail to rank + 1.
Window 0 of the sequence keeps its own head: it carries the gauge. After
``n_sweeps`` block-Gauss-Seidel sweeps, one final solve. Each sweep carries
corrections one window to the right, so ``n_sweeps`` bounds the coupling
range.
"""

from __future__ import annotations

import torch

from ..solvers.ba import BAConfig, BAProblem, BAResult, ba_solve
from .launch import Mesh, send_to_next
from .segments import _to_device


def window_parallel_ba(problem: BAProblem, cfg: BAConfig, mesh: Mesh,
                       n_sweeps: int = 2) -> BAResult:
    """Solve the rank's overlapping BA windows consistently with the other
    ranks' windows.

    ``problem``: the rank's contiguous shard of the windows, batched with a
    leading window axis (k, W, ...) on the rank's device; every rank holds
    the same k (``shard_windows``). ``cfg.n_fixed`` is also the overlap
    width. Returns the rank's (k, ...) BAResult, whose shared boundary
    frames agree with the neighbouring windows' (the left neighbour's tail
    is the right neighbour's fixed head)."""
    n_fixed = cfg.n_fixed
    cams, pts = problem.cam, problem.pts
    for _ in range(n_sweeps):
        res = ba_solve(problem._replace(cam=cams, pts=pts), cfg)
        tails = res.cam[:, -n_fixed:, :]  # (k, n_fixed, 6)
        from_left = send_to_next(mesh, tails[-1])  # zeros on rank 0
        heads = torch.cat([from_left[None], tails[:-1]])
        if mesh.rank == 0:  # the sequence's first window keeps its head: the gauge
            heads = torch.cat([res.cam[:1, :n_fixed], heads[1:]])
        cams = torch.cat([heads, res.cam[:, n_fixed:]], dim=1)
        pts = res.pts
    return ba_solve(problem._replace(cam=cams, pts=pts), cfg)


def shard_windows(problem: BAProblem, mesh: Mesh) -> BAProblem:
    """The rank's contiguous shard of a batched host BAProblem (n_windows,
    ...), on the rank's device. n_windows must divide by the mesh size."""
    n = int(problem.cam.shape[0])
    if n % mesh.size:
        raise ValueError(f"{n} windows do not divide over {mesh.size} ranks")
    k = n // mesh.size
    return BAProblem(*(_to_device(x[mesh.rank * k:(mesh.rank + 1) * k], mesh.device)
                       for x in problem))
