"""Parallel layer of the port: ranks under ``torch.distributed`` in place of
JAX's device mesh (``launch``), segment-sharded VO with the parallel pose
chain (``segments``), window-parallel BA with a halo exchange
(``ba_windows``), the window-sharded unified engine (``unified``) and
covariance-weighted stitching (``stitching``)."""

from .launch import Mesh, make_mesh, run_ranks  # noqa: F401
from .segments import (  # noqa: F401
    chain_motions,
    shard_frames,
    sharded_chain_motions,
    sharded_sequence_vo,
)
from .unified import sharded_unified_scan  # noqa: F401
