"""The JAX package's published configurations 2-4 (``benchmarks/extra_configs.py``)
on the port, against the JAX package, on the CPU at a small size.

- Config 2 (EuRoC-like stereo, ``extra_configs.py:33-106``) at half size:
  the rig's intrinsics halved (240x376), world seed 1, 6 frames,
  ``default_config`` without ``image_shape`` and 64 disparities. One pair's
  ``quad_match_frames`` (grid GFTT, the ZNCC strip at 64 disparities, KLT,
  the prior-guided match) and the staged run on JAX's RANSAC samples, held
  to JAX's with ``test_torch_frontend.py``'s and ``test_torch_pipeline.py``'s
  tolerances. The card runs the full size (``chip_smoke.py``'s
  ``north_star_configs``).
- Config 4 (``extra_configs.py:357-392``) at 3 windows of 10 frames x 64
  points: one batched ``ba_solve`` against ``jax.vmap(ba_solve)`` with
  ``test_torch_ba.py``'s tolerances; and the port's copy of
  ``tests/test_ba.py``'s ``make_window`` and ``perturb``
  (``synthetic.ba_window``), which builds config 4's windows on the card,
  byte for byte equal to the original at two seeds.
- Config 3 (``extra_configs.py:109-209``) at its own size (192x320, 256
  features x 64 disparities): the MI matcher's precision and recall at 1 px
  within 0.01 of JAX's, the median error within 0.02 px, the valid matches
  within 2 %.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_ba import BASELINE, INTR, make_window, perturb
from test_torch_gather import load_module
from test_torch_pipeline import jax_sampler
from uasl_motion_estimation_tpu.models import frontend as jfe
from uasl_motion_estimation_tpu.models import pipeline as jpipe
from uasl_motion_estimation_tpu.ops import image as jim
from uasl_motion_estimation_tpu.ops.geometry import Intrinsics as JaxIntrinsics
from uasl_motion_estimation_tpu.solvers import ba as jba
from uasl_motion_estimation_tpu_torch.config import from_reference_config
from uasl_motion_estimation_tpu_torch.models import frontend as tfe
from uasl_motion_estimation_tpu_torch.models import pipeline as tpipe
from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
from uasl_motion_estimation_tpu_torch.solvers import ba as tba
from uasl_motion_estimation_tpu_torch.utils import synthetic

torch.set_num_threads(1)
SMOKE = load_module("chip_smoke.py")
FULL = SMOKE.EUROC_RIG
HALF = synthetic.CameraRig(fu=FULL["fu"] / 2, fv=FULL["fv"] / 2, cu=FULL["cu"] / 2,
                           cv=FULL["cv"] / 2, baseline=FULL["baseline"],
                           height=FULL["height"] // 2, width=FULL["width"] // 2)
N_FRAMES = 6
BA_WINDOWS, BA_POINTS = 3, 64


@pytest.fixture(scope="module")
def euroc_half():
    """The half-size world on the uint8 wire, JAX's configuration, and JAX's
    staged run (one chunk of all steps)."""
    seq = synthetic.SyntheticStereoSequence(n_frames=N_FRAMES, rig=HALF, seed=SMOKE.EUROC_WORLD)
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    jcfg = jpipe.default_config(JaxIntrinsics(HALF.fu, HALF.fv, HALF.cu, HALF.cv),
                                HALF.baseline)._replace(
        matcher=jfe.MatcherConfig(max_disparity=SMOKE.EUROC_DISP))
    ref = jpipe.OdometryPipeline(jcfg, seed=0)
    ls, rs = ref.stage_frames(frames)
    keys = ref._step_keys(0, N_FRAMES - 1)
    packed = np.asarray(jpipe._vo_scan_packed(ls, rs, keys, jcfg, N_FRAMES - 1))
    return frames, jcfg, np.asarray(ls), np.asarray(rs), packed


def test_config2_configuration_carries_across(euroc_half):
    """extra_configs.py passes no image_shape: the RANSAC spread gate stays
    KITTI's 1000 px^2 on both sides, and the ZNCC strip is 11 x 74."""
    _, jcfg, *_ = euroc_half
    cfg = from_reference_config(jcfg)
    want = tpipe.default_config(Intrinsics(HALF.fu, HALF.fv, HALF.cu, HALF.cv), HALF.baseline
                                )._replace(matcher=tfe.MatcherConfig(max_disparity=64))
    assert cfg == want
    assert cfg.vo.min_spread_area == jcfg.vo.min_spread_area == 1000.0
    assert SMOKE.EUROC_STRIP == (2 * cfg.matcher.patch_radius + 1,
                                 cfg.matcher.max_disparity + 2 * cfg.matcher.patch_radius)


def test_config2_quad_match_matches_jax(euroc_half):
    """One step's front end as the staged engine runs it (frames 0 and 1 on
    the uint8 wire): the valid masks equal on >= 98 % of the slots, and where
    both keep a match its four points (the grid feature first) within 2e-3 px."""
    _, jcfg, ls, rs, _ = euroc_half
    imgs = [x.astype(np.float32) for x in (ls[0], rs[0], ls[1], rs[1])]
    kw = (("nms_radius", jcfg.detect_nms_radius), ("quality_level", jcfg.detect_quality))
    cfg = from_reference_config(jcfg)
    t = tfe.quad_match_frames(*(torch.from_numpy(x) for x in imgs), max_features=cfg.max_features,
                              matcher=cfg.matcher, klt=cfg.klt, detect_kwargs=kw)
    j = jfe.quad_match_frames(*(jnp.asarray(x) for x in imgs), max_features=jcfg.max_features,
                              matcher=jcfg.matcher, klt=jcfg.klt, detect_kwargs=kw)
    tv, jv = t.valid.numpy(), np.asarray(j.valid)
    assert (tv == jv).mean() >= 0.98
    both = tv & jv
    assert both.sum() > 50
    np.testing.assert_allclose(t.uv.numpy()[both], np.asarray(j.uv)[both], atol=2e-3)


def test_config2_staged_matches_jax_with_injected_samples(euroc_half):
    frames, jcfg, _, _, want = euroc_half
    pipe = tpipe.OdometryPipeline(from_reference_config(jcfg), seed=0, device="cpu",
                                  sampler=jax_sampler(jcfg))
    ls, rs = pipe.stage_frames(frames)
    got = tpipe._vo_scan_packed(ls, rs, 0, pipe.sampler, pipe.cfg, SMOKE.EUROC_CHUNK).numpy()
    assert got.shape == want.shape == (N_FRAMES - 1, 20)
    np.testing.assert_array_equal(got[:, 16], want[:, 16])
    assert want[:, 16].all()
    mt, mj = got[:, :16].reshape(-1, 4, 4), want[:, :16].reshape(-1, 4, 4)
    np.testing.assert_allclose(mt[:, :3, :3], mj[:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(mt[:, :3, 3], mj[:, :3, 3], atol=1e-3)
    assert np.all(np.abs(got[:, 17] - want[:, 17]) <= 0.02 * jcfg.max_features)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("stereo", [True, False])
def test_ba_window_copy_is_byte_equal(seed, stereo):
    """synthetic.ba_window and perturb_ba_window draw what tests/test_ba.py's
    make_window and perturb draw, at config 4's size and seeds."""
    want = make_window(n_frames=10, n_pts=256, noise=0.3, stereo=stereo, seed=seed)
    got = synthetic.ba_window(Intrinsics(*INTR), BASELINE, n_frames=10, n_pts=256, noise=0.3,
                              stereo=stereo, seed=seed)
    want += perturb(want[0], want[1], seed=seed + 100)
    got += synthetic.perturb_ba_window(got[0], got[1], seed=seed + 100)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()


def test_config4_batch_matches_jax_vmap():
    """Config 4's windows at 3 x 10 frames x 64 points: one batched solve on
    the port, jax.vmap(ba_solve) on JAX."""
    windows = []
    for s in range(BA_WINDOWS):
        cams, pts, obs, mask = make_window(n_frames=10, n_pts=BA_POINTS, noise=0.3, seed=s)
        windows.append((*perturb(cams, pts, seed=s + 100), obs, mask))
    arrays = [np.stack(x) for x in zip(*windows)]
    jcfg = jba.BAConfig(intr=INTR, baseline=BASELINE)
    want = jax.device_get(jax.jit(jax.vmap(lambda p: jba.ba_solve(p, jcfg)))(
        jba.BAProblem(*(jnp.asarray(a) for a in arrays))))
    got = tba.ba_solve(tba.BAProblem(*(torch.from_numpy(a) for a in arrays)),
                       from_reference_config(jcfg))
    np.testing.assert_allclose(got.cam.numpy(), want.cam, atol=1e-4)
    pts = np.asarray(want.pts)
    np.testing.assert_allclose(got.pts.numpy(), pts, atol=1e-4 * np.abs(pts).max())
    np.testing.assert_array_equal(got.converged.numpy(), want.converged)
    np.testing.assert_array_equal(got.n_iter.numpy(), want.n_iter)
    np.testing.assert_allclose(got.cost.numpy(), want.cost, rtol=1e-5)
    assert got.converged.all()


def test_config3_mi_matcher_accuracy_matches_jax():
    """The accuracy block of config 3 on both sides, and JAX's figures as
    chip_smoke.py pins them."""
    seq = synthetic.SyntheticStereoSequence(n_frames=1, rig=SMOKE.small_rig(), seed=SMOKE.MI_WORLD)
    left, right = seq.frame(0)
    left, right = jnp.asarray(left, jnp.float32), jnp.asarray(255.0 - right, jnp.float32)
    feats, _, v0 = jim.detect_features(left, max_features=SMOKE.MI_FEATURES)
    cfg = jfe.MatcherConfig(max_disparity=SMOKE.MI_DISP)
    fr, _, v = jax.jit(jfe.match_stereo, static_argnames=("cfg", "use_mi"))(
        left, right, feats, v0, cfg=cfg, use_mi=True)
    want = SMOKE.mi_accuracy(np.asarray(feats), np.asarray(v0), np.asarray(fr), np.asarray(v),
                             seq.gt_disparity(0), cfg.min_disparity, cfg.max_disparity)
    got = SMOKE.mi_matcher_accuracy(torch.device("cpu"))
    for k, tol in SMOKE.MI_TOL.items():
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])
    assert abs(got["valid_matches"] - want["valid_matches"]) <= SMOKE.MI_VALID_TOL * want[
        "valid_matches"]
    assert want == pytest.approx(SMOKE.JAX_MI, rel=1e-6)
