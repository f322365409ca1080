"""Sequence sharding: segment-parallel stereo VO and the parallel pose chain.

Port of ``uasl_motion_estimation_tpu/parallel/segments.py``. A sequence's
frame pairs are split into contiguous segments, one per rank
(``launch.run_ranks``); each rank runs the front-end and the 6-DoF solve of
its pairs as one batch, and the pose chain pose_i = pose_{i-1} @
inv(motion_i) is a prefix product: a local doubling scan on each rank, one
``all_gather`` of the per-rank totals and a prefix correction.

Every function here runs inside each rank on the rank's local shard and
returns the rank's local shard. RANSAC samples of pair i come from
``sampler(i, valid)`` with i the GLOBAL pair index, so the sharded run
solves each pair with the samples the single-process engines draw for it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.pipeline import PipelineConfig, Sampler, _step
from .launch import Mesh, all_gather
from .stitching import prefix_products


def chain_motions(motions: torch.Tensor) -> torch.Tensor:
    """(B, 4, 4) frame-to-frame motions -> (B, 4, 4) cam-to-world poses.

    ``motions[i]`` maps frame-i points into frame i+1; the pose is the
    inclusive prefix product of the inverses."""
    return prefix_products(torch.linalg.inv(motions))


def _sharded_chain(inv_local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Local scan, then the product of the earlier ranks' totals in front."""
    local = prefix_products(inv_local)
    totals = all_gather(mesh, local[-1])  # (size, 4, 4)
    eye = torch.eye(4, dtype=local.dtype, device=local.device)[None]
    before = prefix_products(torch.cat([eye, totals[:-1]]))[mesh.rank]
    return torch.matmul(before, local)


def sharded_chain_motions(motions: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``chain_motions`` of the rank's contiguous shard (b, 4, 4) of the
    sequence's motions: the rank's (b, 4, 4) poses in the global chain."""
    return _sharded_chain(torch.linalg.inv(motions), mesh)


def _to_device(x, device: torch.device) -> torch.Tensor:
    """A numpy array (a memory map too) or a tensor, on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.array(x)).to(device)  # a copy: memory maps are read-only


def shard_frames(frames, mesh: Mesh) -> torch.Tensor:
    """The rank's contiguous slice of a host stack ``frames`` (B, ...), on
    the rank's device. B must be divisible by the mesh size."""
    n = int(frames.shape[0])
    if n % mesh.size:
        raise ValueError(f"{n} entries do not divide over {mesh.size} ranks")
    b = n // mesh.size
    return _to_device(frames[mesh.rank * b:(mesh.rank + 1) * b], mesh.device)


def sharded_sequence_vo(prev_left: torch.Tensor, prev_right: torch.Tensor,
                        cur_left: torch.Tensor, cur_right: torch.Tensor, sampler: Sampler,
                        cfg: PipelineConfig, mesh: Mesh):
    """Front-end + VO of the rank's frame pairs, and their poses in the
    global chain.

    ``prev_*``, ``cur_*`` (b, H, W): the rank's contiguous shard of the
    pairs (frame i with frame i + 1; ``shard_frames`` of ``ls[:-1]`` and
    ``ls[1:]``), uint8 or float32; every rank holds the same b, so the
    rank's first pair is global pair ``rank * b``. Returns (poses (b, 4, 4)
    cam-to-world relative to frame 0, success (b,), n_inliers (b,), cov
    (b, 6, 6) per-motion covariance on the [dt, dtheta] tangent). A failed
    pair contributes the identity motion to the chain."""
    b = int(prev_left.shape[0])
    imgs = [x.to(mesh.device, torch.float32) for x in (prev_left, prev_right, cur_left, cur_right)]
    steps = list(range(mesh.rank * b, (mesh.rank + 1) * b))
    out = _step(*imgs, steps, sampler, cfg)
    eye = torch.eye(4, dtype=out.motion.dtype, device=out.motion.device)
    motion = torch.where(out.success[:, None, None], out.motion, eye)
    poses = sharded_chain_motions(motion, mesh)
    return poses, out.success, out.n_inliers, out.cov
