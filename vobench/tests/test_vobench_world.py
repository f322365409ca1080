"""The benchmark's device renderer and its frozen copies against the port's
numpy originals (``utils/synthetic.py``), on the CPU."""

import numpy as np
import pytest
import torch

from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
from uasl_motion_estimation_tpu_torch.utils import synthetic as sy
from vobench.world import render_torch as rt

# 96 x 320 rigs: a plain one, and KITTI 00's and EuRoC MH01's intrinsics
# scaled to that image
RIGS = {
    "plain": sy.CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=48.0, baseline=0.54, height=96, width=320),
    "kitti": sy.CameraRig(fu=718.856 * 320 / 1241, fv=718.856 * 96 / 376, cu=607.19 * 320 / 1241,
                          cv=185.22 * 96 / 376, baseline=0.5372, height=96, width=320),
    "euroc": sy.CameraRig(fu=458.65 * 320 / 752, fv=457.3 * 96 / 480, cu=367.2 * 320 / 752,
                          cv=248.4 * 96 / 480, baseline=0.11, height=96, width=320),
}


@pytest.mark.parametrize("name", sorted(RIGS))
def test_render_matches_numpy_renderer(name):
    rig = RIGS[name]
    seq = sy.SyntheticStereoSequence(n_frames=80, rig=rig, seed=5)
    hall = rt.Hall(5, "cpu")
    np.testing.assert_array_equal(hall.textures.numpy(), np.stack([p.texture for p in seq.planes]))
    poses = rt.kitti_like_trajectory(80)
    np.testing.assert_array_equal(poses, seq.poses)
    idx = [0, 41, 79]
    r = rt.Rig(*rig)
    left = hall.render_f64(poses[idx], r).numpy()
    right = hall.render_f64(rt.right_poses(poses[idx], r.baseline), r).numpy()
    for k, i in enumerate(idx):
        l_np, r_np = seq.frame(i)
        assert np.abs(left[k] - l_np).max() <= 1e-3
        assert np.abs(right[k] - r_np).max() <= 1e-3
    u8 = hall.render(poses[idx], r).numpy()
    np.testing.assert_array_equal(u8, np.clip(np.stack([seq.frame(i)[0] for i in idx]), 0, 255)
                                  .astype(np.uint8))


@pytest.mark.parametrize("seed", [0, 7])
def test_ba_window_copies_equal_the_port(seed):
    intr = Intrinsics(718.856, 718.856, 607.19, 185.22)
    ours = rt.ba_window(intr, 0.5372, n_frames=10, n_pts=256, noise=0.3, seed=seed,
                        image_shape=(376, 1241))
    port = sy.ba_window(intr, 0.5372, n_frames=10, n_pts=256, noise=0.3, seed=seed,
                        image_shape=(376, 1241))
    for a, b in zip(ours, port):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(rt.perturb_ba_window(ours[0], ours[1], seed=seed + 100),
                    sy.perturb_ba_window(port[0], port[1], seed=seed + 100)):
        np.testing.assert_array_equal(a, b)


def test_batched_ba_windows_equal_one_at_a_time():
    intr = Intrinsics(718.856, 718.856, 607.19, 185.22)
    seeds = [11, 3, 4531]
    batch = rt.ba_windows(intr, 0.5372, seeds, 10, 256, 0.3, (376, 1241))
    for j, s in enumerate(seeds):
        cams, pts, obs, mask = rt.ba_window(intr, 0.5372, n_frames=10, n_pts=256, noise=0.3,
                                            seed=s, image_shape=(376, 1241))
        one = (*rt.perturb_ba_window(cams, pts, seed=s + 100), obs, mask)
        for a, b in zip(batch, one):
            np.testing.assert_array_equal(a[j], b)


def test_so3_exp_copy_equals_the_port():
    from uasl_motion_estimation_tpu_torch.ops import lie

    v = torch.tensor([[0.0, 0.0, 0.0], [1e-5, -2e-5, 3e-6], [0.3, -0.2, 0.1]])
    torch.testing.assert_close(rt.so3_exp_f32(v), lie.so3_exp(v), rtol=0, atol=0)
