"""The port's staged stereo-VO slice end to end against the JAX reference:
8 rendered frames of the 192x320 rig, ``max_features=256``, seed 0.

The JAX reference runs once (module fixture). With the JAX-drawn RANSAC
samples injected through the pipeline's ``sampler`` the port must succeed on
the same steps, keep match counts within 2% of the feature budget, and give
per-step motions within 1e-4 (rotation entries) and 1e-3 m (translation).
Measured here: equal counts and differences near 1e-6; the bounds leave room
for float32 summation order flipping a near-tied pick, which moves a few
matches and so the refine's inlier set. With its own sampler the port must
reach ATE < 0.1 m.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uasl_motion_estimation_tpu.models import pipeline as jpipe
from uasl_motion_estimation_tpu.models.stereo_vo import _sample_hypotheses as jax_sample
from uasl_motion_estimation_tpu.ops.geometry import Intrinsics as JaxIntrinsics
from uasl_motion_estimation_tpu_torch._shared import metrics, synthetic
from uasl_motion_estimation_tpu_torch.config import from_reference_config
from uasl_motion_estimation_tpu_torch.models import pipeline as tpipe
from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics

torch.set_num_threads(1)
RIG = synthetic.CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                          height=192, width=320)
N_FRAMES = 8


@pytest.fixture(scope="module")
def world():
    seq = synthetic.SyntheticStereoSequence(n_frames=N_FRAMES, rig=RIG, seed=0)
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    jcfg = jpipe.default_config(JaxIntrinsics(RIG.fu, RIG.fv, RIG.cu, RIG.cv),
                                RIG.baseline)._replace(max_features=256)
    ref = jpipe.OdometryPipeline(jcfg, seed=0)
    ls, rs = ref.stage_frames(frames)
    keys = ref._step_keys(0, N_FRAMES - 1)
    packed = np.asarray(jpipe._vo_scan_packed(ls, rs, keys, jcfg, N_FRAMES - 1))
    return seq, frames, jcfg, packed


def jax_sampler(jcfg, seed=0):
    base = jax.random.key(seed)

    def sample(step, valid):
        key = jax.random.fold_in(base, step)
        idx = jax_sample(key, jcfg.vo.n_ransac, jnp.asarray(valid.cpu().numpy()))
        return torch.from_numpy(np.array(idx)).to(valid.device)

    return sample


def test_config_carries_across(world):
    _, _, jcfg, _ = world
    cfg = from_reference_config(jcfg)
    want = tpipe.default_config(Intrinsics(RIG.fu, RIG.fv, RIG.cu, RIG.cv),
                                RIG.baseline)._replace(max_features=256)
    assert cfg == want
    assert isinstance(cfg.vo.intr1, Intrinsics)


@pytest.mark.parametrize("chunk", [3, 7])
def test_staged_slice_matches_jax_with_injected_samples(world, chunk):
    seq, frames, jcfg, want = world
    pipe = tpipe.OdometryPipeline(from_reference_config(jcfg), seed=0, device="cpu",
                                  sampler=jax_sampler(jcfg))
    ls, rs = pipe.stage_frames(frames)
    got = tpipe._vo_scan_packed(ls, rs, 0, pipe.sampler, pipe.cfg, chunk).numpy()
    assert got.shape == want.shape == (N_FRAMES - 1, 20)
    np.testing.assert_array_equal(got[:, 16], want[:, 16])  # success flags
    assert want[:, 16].all()
    motion_t, motion_j = got[:, :16].reshape(-1, 4, 4), want[:, :16].reshape(-1, 4, 4)
    np.testing.assert_allclose(motion_t[:, :3, :3], motion_j[:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(motion_t[:, :3, 3], motion_j[:, :3, 3], atol=1e-3)
    # match counts within 2% of the feature budget
    assert np.all(np.abs(got[:, 17] - want[:, 17]) <= 0.02 * 256)


def test_own_sampler_ate_and_engines_agree(world):
    seq, frames, jcfg, _ = world
    cfg = from_reference_config(jcfg)
    pipe = tpipe.OdometryPipeline(cfg, seed=0, device="cpu")
    ls, rs = pipe.stage_frames(frames)
    staged = pipe.run_staged(ls, rs, chunk=4)
    assert staged.shape == (N_FRAMES, 4, 4)
    assert metrics.ate_rmse(staged[:, :3, 3], seq.gt_positions()) < 0.1
    # the per-frame engine solves step i with the same samples: on the
    # same uint8 frames it gives the same trajectory
    pipe.reset()
    u8 = [tuple(np.clip(x, 0, 255).astype(np.uint8) for x in f) for f in frames]
    per_frame = pipe.run(u8)
    np.testing.assert_allclose(per_frame, staged, atol=1e-4)
