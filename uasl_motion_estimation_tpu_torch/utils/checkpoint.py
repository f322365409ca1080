"""Checkpoint and resume of a running latency-mode session.

Port of ``uasl_motion_estimation_tpu/utils/checkpoint.py``. The reference has
no persistence (its only resume is starting mid-sequence, FrameInfo.fframe,
file_IO.h:42-64); this saves the whole state an ``OdometrySystem``
(models/odometry.py) holds: the pose chain, the keyframe (its image and
pose), the keyframe count, the BA window, the frame index, the RANSAC seed,
``use_ba`` and the track table. The RANSAC samples are keyed on (seed,
frame index), so a resumed run draws what the uninterrupted one drew.

Plain ``.npz``: a few MB of arrays, readable from any tool. The system's
device is not state, nor is a sampler injected into it: they stay the
system's own.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..models import tracks as tr

FORMAT_VERSION = 1


def save_checkpoint(path: str, system) -> None:
    """Write an ``OdometrySystem``'s state to ``path`` (.npz)."""
    arrays = {
        "pose": np.asarray(system.pose),
        "trajectory": np.asarray(system.trajectory),
        "kf_pose": np.asarray(system.kf_pose),
        "window_poses": (np.asarray(system.window_poses) if system.window_poses
                         else np.zeros((0, 4, 4))),
        "window_traj_idx": np.asarray(system.window_traj_idx, np.int64),
    }
    if system.kf_left is not None:
        arrays["kf_left"] = system.kf_left.cpu().numpy()
    if system.table is not None:
        for name in tr.TrackTable._fields:
            arrays[f"table_{name}"] = getattr(system.table, name).cpu().numpy()
    meta = {
        "version": FORMAT_VERSION,
        "frame_idx": system.frame_idx,
        "n_keyframes": system.n_keyframes,
        "seed": system.seed,
        "use_ba": system.use_ba,
        "has_table": system.table is not None,
    }
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8).copy()
    np.savez_compressed(path, **arrays)


def load_checkpoint(path: str, system) -> None:
    """Restore the state ``save_checkpoint`` wrote into ``system`` (in
    place), its tensors on the system's device."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        if meta["version"] != FORMAT_VERSION:
            raise ValueError(f"checkpoint version {meta['version']} unsupported")
        dev = system.device
        system.set_seed(int(meta["seed"]))
        system.pose = data["pose"]
        system.trajectory = list(data["trajectory"])
        system.kf_pose = data["kf_pose"]
        system.window_poses = list(data["window_poses"])
        system.window_traj_idx = [int(i) for i in data["window_traj_idx"]]
        system.frame_idx = int(meta["frame_idx"])
        system.n_keyframes = int(meta["n_keyframes"])
        system.use_ba = bool(meta["use_ba"])
        system.kf_left = (torch.from_numpy(data["kf_left"]).to(dev) if "kf_left" in data
                          else None)
        system.table = (tr.TrackTable(*(torch.from_numpy(data[f"table_{name}"]).to(dev)
                                        for name in tr.TrackTable._fields))
                        if meta["has_table"] else None)


def checkpoint_every(system, directory: str, every: int = 50) -> str | None:
    """Checkpoint keyed by frame number every ``every`` frames; returns the
    path written, or None when none was due."""
    if system.frame_idx == 0 or system.frame_idx % every:
        return None
    Path(directory).mkdir(parents=True, exist_ok=True)
    path = str(Path(directory) / f"ckpt_{system.frame_idx:08d}.npz")
    save_checkpoint(path, system)
    return path
