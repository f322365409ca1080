"""Checkpoint and resume of the port's latency mode (``utils/checkpoint.py``):
what JAX's ``tests/test_utils.py::TestCheckpoint`` asks of the JAX package,
held on the port, on the 192x320 rig with 128 tracks.

A run checkpointed after 4 frames and resumed in a fresh system gives the
uninterrupted run's trajectory bit for bit on the CPU, with BA and the
parallax gate on, and the restored state equals the saved one field by
field; a checkpoint taken before the first frame restores an empty
system; ``checkpoint_every`` writes only on its frames; the RANSAC seed
travels with the checkpoint; another format version is refused.
"""

import json

import numpy as np
import pytest
import torch

from uasl_motion_estimation_tpu_torch.models.frontend import MatcherConfig
from uasl_motion_estimation_tpu_torch.models.odometry import OdometryConfig, OdometrySystem
from uasl_motion_estimation_tpu_torch.models.stereo_vo import StereoVOParams
from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
from uasl_motion_estimation_tpu_torch.utils import synthetic
from uasl_motion_estimation_tpu_torch.utils.checkpoint import (
    checkpoint_every, load_checkpoint, save_checkpoint)

torch.set_num_threads(1)
RIG = synthetic.CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                          height=192, width=320)
INTR = Intrinsics(RIG.fu, RIG.fv, RIG.cu, RIG.cv)
CFG = OdometryConfig(vo=StereoVOParams(intr1=INTR, intr2=INTR, baseline=RIG.baseline),
                     max_tracks=128, window=3, ba_rate=2, parallax=1.0,
                     matcher=MatcherConfig(max_disparity=96))


def system(seed=1):
    return OdometrySystem(CFG, seed=seed, device="cpu")


@pytest.fixture(scope="module")
def frames():
    seq = synthetic.SyntheticStereoSequence(n_frames=8, rig=RIG, seed=4)
    return [seq.frame(i) for i in range(8)]


def state(s):
    table = None if s.table is None else [x.numpy().copy() for x in s.table]
    kf = None if s.kf_left is None else s.kf_left.numpy().copy()
    return (np.asarray(s.pose), np.asarray(s.trajectory), np.asarray(s.kf_pose), kf,
            s.n_keyframes, np.asarray(s.window_poses), list(s.window_traj_idx), s.frame_idx,
            s.seed, s.use_ba, table)


def assert_same_state(a, b):
    for x, y in zip(state(a), state(b)):
        if isinstance(x, list) and x and isinstance(x[0], np.ndarray):
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
                assert u.dtype == v.dtype
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


def test_roundtrip_resume_bitexact(frames, tmp_path):
    a = system()
    recs = [a.process_pair(*f) for f in frames[:4]]
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, a)
    b = system(seed=5)  # the seed comes from the checkpoint
    load_checkpoint(path, b)
    assert_same_state(a, b)
    assert b.frame_idx == 4 and b.seed == 1
    recs += [a.process_pair(*f) for f in frames[4:]]
    resumed = [b.process_pair(*f) for f in frames[4:]]
    np.testing.assert_array_equal(np.asarray(a.trajectory), np.asarray(b.trajectory))
    assert [r.get("keyframe") for r in recs[4:]] == [r.get("keyframe") for r in resumed]
    assert any("ba_cost" in r for r in recs)
    assert_same_state(a, b)


def test_checkpoint_before_first_frame(frames, tmp_path):
    path = str(tmp_path / "c0.npz")
    save_checkpoint(path, system())
    b = system()
    b.process_pair(*frames[0])
    load_checkpoint(path, b)
    assert b.table is None and b.kf_left is None and b.frame_idx == 0
    assert b.n_keyframes == 0 and b.window_poses == [] and len(b.trajectory) == 1
    np.testing.assert_array_equal(b.run(frames[:3]), system().run(frames[:3]))


def test_checkpoint_every_and_version(frames, tmp_path):
    s = system()
    written = []
    for f in frames[:5]:
        s.process_pair(*f)
        written.append(checkpoint_every(s, str(tmp_path / "ckpts"), every=2))
    assert written == [None, str(tmp_path / "ckpts" / "ckpt_00000002.npz"), None,
                       str(tmp_path / "ckpts" / "ckpt_00000004.npz"), None]
    data = dict(np.load(written[3]))
    meta = json.loads(bytes(data["meta"]).decode())
    meta["version"] = 99
    data["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **data)
    with pytest.raises(ValueError, match="version 99"):
        load_checkpoint(bad, system())
