"""Parity of the port's front-end stages (match_stereo, klt_track,
quad_match_frames) with the JAX package on rendered synthetic frames
(192x320 rig, seed 0).

Tolerance: the valid masks agree on at least 98% of the feature slots, and
where both sides keep a feature its points agree within 1e-3 px for one
stage, 2e-3 px for the quad match (whose current-right point has gone
through four resampling stages, each adding float32 rounding that the
Lucas-Kanade solves amplify on weak texture). The masks may differ at all
because float32 sums are taken in another order on each side, which can flip
a near-tied argmax (cost-volume peak, grid cell) or a threshold test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uasl_motion_estimation_tpu.models import frontend as jfe
from uasl_motion_estimation_tpu.ops import image as jim
from uasl_motion_estimation_tpu_torch._shared import synthetic
from uasl_motion_estimation_tpu_torch.models import frontend as tfe
from uasl_motion_estimation_tpu_torch.ops import image as tim

torch.set_num_threads(1)
RIG = synthetic.CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                          height=192, width=320)
KW = (("nms_radius", 5), ("quality_level", 1e-4))
N = 256
RNG_PRIOR = np.random.default_rng(2)


@pytest.fixture(scope="module")
def frames():
    seq = synthetic.SyntheticStereoSequence(n_frames=3, rig=RIG, seed=0)
    return [tuple(np.clip(x, 0, 255).astype(np.uint8).astype(np.float32)
                  for x in seq.frame(i)) for i in range(3)]


@pytest.fixture(scope="module")
def feats(frames):
    xy, _, v = jim.detect_features_grid(jnp.asarray(frames[0][0]), N, 1e-4)
    return np.array(xy), np.array(v)


def agree(t_pts, t_valid, j_pts, j_valid, min_match=0.98, atol=1e-3):
    t_pts, t_valid = t_pts.numpy(), t_valid.numpy()
    j_pts, j_valid = np.asarray(j_pts), np.asarray(j_valid)
    assert (t_valid == j_valid).mean() >= min_match
    both = t_valid & j_valid
    assert both.sum() > 0.3 * len(both)
    np.testing.assert_allclose(t_pts[both], j_pts[both], atol=atol)


@pytest.mark.parametrize("prior", [False, True])
def test_match_stereo(frames, feats, prior):
    left, right = frames[0]
    xy, v = feats
    kw_t, kw_j = {}, {}
    if prior:
        d = (RNG_PRIOR.uniform(-3, 3, N) + 20.0).astype(np.float32)
        kw_t, kw_j = dict(d_prior=torch.from_numpy(d)), dict(d_prior=jnp.asarray(d))
    t_fr, t_s, t_v = tfe.match_stereo(torch.from_numpy(left), torch.from_numpy(right),
                                      torch.from_numpy(xy), torch.from_numpy(v), **kw_t)
    j_fr, j_s, j_v = jfe.match_stereo(jnp.asarray(left), jnp.asarray(right),
                                      jnp.asarray(xy), jnp.asarray(v), **kw_j)
    agree(t_fr, t_v, j_fr, j_v)


def test_klt_track(frames, feats):
    xy, v = feats
    t = tfe.klt_track(torch.from_numpy(frames[0][0]), torch.from_numpy(frames[1][0]),
                      torch.from_numpy(xy), torch.from_numpy(v))
    j = jfe.klt_track(jnp.asarray(frames[0][0]), jnp.asarray(frames[1][0]),
                      jnp.asarray(xy), jnp.asarray(v))
    agree(t.pts, t.valid, j.pts, j.valid)
    ok = t.valid.numpy() & np.asarray(j.valid)
    # residual: mean |intensity error| (0-255 scale); 1e-3 px of point
    # difference times image gradients of ~20/px gives ~2e-2 at most
    np.testing.assert_allclose(t.residual.numpy()[ok], np.asarray(j.residual)[ok],
                               rtol=1e-3, atol=2e-2)


def test_klt_batch_freezes_each_problem(frames, feats):
    """The batched KLT equals each problem run alone: a problem that has
    converged is frozen while the others iterate (vmap of while_loop)."""
    xy, v = feats
    prev = torch.from_numpy(np.stack([frames[0][0], frames[1][0]]))
    nxt = torch.from_numpy(np.stack([frames[1][0], frames[2][0]]))
    pts = torch.from_numpy(np.stack([xy, xy]))
    val = torch.from_numpy(np.stack([v, v]))
    # the second problem starts from a far guess so it iterates longer
    init = pts + torch.tensor([[[0.0, 0.0]], [[4.0, -3.0]]])
    batched = tfe.klt_track(prev, nxt, pts, val, init_next=init)
    for b in range(2):
        alone = tfe.klt_track(prev[b], nxt[b], pts[b], val[b], init_next=init[b])
        np.testing.assert_array_equal(batched.valid[b].numpy(), alone.valid.numpy())
        np.testing.assert_allclose(batched.pts[b].numpy(), alone.pts.numpy(), atol=1e-4)


def test_quad_match_frames(frames):
    (pl, pr), (cl, cr) = frames[0], frames[1]
    t = tfe.quad_match_frames(*(torch.from_numpy(x) for x in (pl, pr, cl, cr)),
                              max_features=N, detect_kwargs=KW)
    j = jfe.quad_match_frames(*(jnp.asarray(x) for x in (pl, pr, cl, cr)),
                              max_features=N, detect_kwargs=KW)
    assert t.uv.shape == (N, 4, 2)
    tv, jv = t.valid.numpy(), np.asarray(j.valid)
    assert (tv == jv).mean() >= 0.98
    both = tv & jv
    assert both.sum() > 50
    np.testing.assert_allclose(t.uv.numpy()[both], np.asarray(j.uv)[both], atol=2e-3)


def test_quad_match_frames_batched_with_shared_pyramids(frames):
    """The staged layout: a batch of steps with prebuilt left pyramids gives
    what each step gives alone."""
    lefts = torch.from_numpy(np.stack([f[0] for f in frames]))
    rights = torch.from_numpy(np.stack([f[1] for f in frames]))
    pyr = tim.build_pyramid(lefts, 4)
    b = tfe.quad_match_frames(lefts[:-1], rights[:-1], lefts[1:], rights[1:],
                              max_features=N, detect_kwargs=KW,
                              pyr_prev_left=[p[:-1] for p in pyr],
                              pyr_cur_left=[p[1:] for p in pyr])
    for i in range(2):
        one = tfe.quad_match_frames(lefts[i], rights[i], lefts[i + 1], rights[i + 1],
                                    max_features=N, detect_kwargs=KW)
        np.testing.assert_array_equal(b.valid[i].numpy(), one.valid.numpy())
        np.testing.assert_allclose(b.uv[i].numpy(), one.uv.numpy(), atol=1e-4)


def test_unported_options_raise(frames):
    x = torch.from_numpy(frames[0][0])
    with pytest.raises(NotImplementedError):
        tfe.match_stereo(x, x, torch.zeros(4, 2), torch.ones(4, dtype=torch.bool),
                         use_mi=True)
    with pytest.raises(NotImplementedError):
        tfe.quad_match_frames(x, x, x, x, max_features=16, detector="topk")


def test_configs_mirror_jax_defaults():
    assert tfe.MatcherConfig()._asdict() == jfe.MatcherConfig()._asdict()
    assert tfe.KLTConfig()._asdict() == jfe.KLTConfig()._asdict()
    assert jax.devices()[0].platform == "cpu"
