"""Parity of the port's cross-modal metric-scale session with the JAX package,
on the CPU, at the 192x320 rig of tests/test_scale.py (seed 3, 8 frames,
256 features, 64 disparities): the MI matcher (models/frontend.py),
``estimate_scale`` (models/scale.py), ``lm_solve(minimize=False)``
(solvers/lm.py), the staged and per-frame sessions (models/cross_modal.py),
and the port's copies of utils/synthetic.py and utils/metrics.py.

Tolerances and why:
- MI scores are quantised: a float32 difference in a bilinear patch can move
  one pixel across a bin edge and change a score by ~1/121 of a bin's
  weight, and exact ties between disparity candidates are common. So the MI
  matcher is held to equal valid masks on >= 98 % of features and, where
  both accept, disparities within 1e-3 px on >= 98 % of them.
- estimate_scale and the session: scales within 2e-3 relative of JAX (the
  LM polishes on the same quantised objective); rotations within 1e-3 and
  positions within 5e-3 m over the 8 frames.
- With its own sampler the port is held to the JAX tests' accuracy bars:
  median relative scale error < 2 %, max < 6 %, ATE < 0.06 m.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_mono import jax_mono_samples
from uasl_motion_estimation_tpu.models import cross_modal as jcm
from uasl_motion_estimation_tpu.models import frontend as jfe
from uasl_motion_estimation_tpu.models import mono_vo as jmv
from uasl_motion_estimation_tpu.models import scale as jsc
from uasl_motion_estimation_tpu.ops import geometry as jgeo
from uasl_motion_estimation_tpu.solvers import lm as jlm
from uasl_motion_estimation_tpu.utils import metrics as jmetrics
from uasl_motion_estimation_tpu.utils import synthetic as jsyn
from uasl_motion_estimation_tpu_torch import device as tdevice
from uasl_motion_estimation_tpu_torch.config import from_reference_config
from uasl_motion_estimation_tpu_torch.models import cross_modal as tcm
from uasl_motion_estimation_tpu_torch.models import frontend as tfe
from uasl_motion_estimation_tpu_torch.models import scale as tsc
from uasl_motion_estimation_tpu_torch.ops import image as tim
from uasl_motion_estimation_tpu_torch.solvers import lm as tlm
from uasl_motion_estimation_tpu_torch.utils import metrics, synthetic

torch.set_num_threads(1)
RIG = synthetic.CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                          height=192, width=320)
N_FRAMES = 8
JINTR = jgeo.Intrinsics(RIG.fu, RIG.fv, RIG.cu, RIG.cv)


def jax_config():
    return jcm.CrossModalConfig(
        vo=jmv.MonoVOParams(intr=JINTR),
        scale=jsc.ScaleConfig(intr=JINTR, baseline=RIG.baseline),
        matcher=jfe.MatcherConfig(max_disparity=64),
        max_features=256,
    )


def jax_session_sampler(seed: int, n_ransac: int):
    """The JAX session's draw for global step i: key fold_in(key(seed), i),
    recomputed from the port's valid mask."""
    base = jax.random.key(seed)

    def sample(step, valid):
        key = jax.random.fold_in(base, step)
        idx = jax_mono_samples(key, n_ransac, valid.cpu().numpy())
        return torch.from_numpy(idx).to(valid.device)

    return sample


@pytest.fixture(scope="module")
def world():
    seq = synthetic.SyntheticStereoSequence(n_frames=N_FRAMES, rig=RIG, seed=3, cross_modal=True)
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    # the uint8 wire format, for both engines
    wire = [(np.clip(a, 0, 255).astype(np.uint8).astype(np.float32),
             np.clip(b, 0, 255).astype(np.uint8).astype(np.float32)) for a, b in frames]
    gt_speed = np.linalg.norm(np.diff(seq.poses[:, :3, 3], axis=0), axis=1)
    return seq, wire, gt_speed


@pytest.fixture(scope="module")
def jax_staged(world):
    _, wire, _ = world
    return jcm.run_cross_modal_staged(wire, jax_config(), seed=0, chunk=4)


def _scale_errors(res, gt_speed):
    return np.abs(res.scales - gt_speed) / gt_speed


def test_config_carries_across():
    jcfg = jax_config()
    cfg = from_reference_config(jcfg)
    assert isinstance(cfg, tcm.CrossModalConfig)
    assert cfg.matcher.max_disparity == 64 and cfg.max_features == 256
    for port_t, jax_t in ((tcm.CrossModalConfig, jcm.CrossModalConfig),
                          (tsc.ScaleConfig, jsc.ScaleConfig)):
        assert port_t._fields == jax_t._fields
    assert tsc.ScaleConfig(intr=None, baseline=1.0)._asdict() == \
        jsc.ScaleConfig(intr=None, baseline=1.0)._asdict()


def test_utils_copies_match_jax():
    """The port's own synthetic.py and metrics.py: byte-equal renders and
    ground truth, equal metrics."""
    rig = synthetic.CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                              height=48, width=80)
    for kw in ({"cross_modal": True}, {"corruption": synthetic.CorruptionConfig()}):
        jkw = dict(kw)
        if "corruption" in kw:
            jkw["corruption"] = jsyn.CorruptionConfig()
        mine = synthetic.SyntheticStereoSequence(n_frames=3, rig=rig, seed=1, tex_size=128, **kw)
        ref = jsyn.SyntheticStereoSequence(n_frames=3, rig=jsyn.CameraRig(*rig), seed=1,
                                           tex_size=128, **jkw)
        for i in range(3):
            for a, b in zip(mine.frame(i), ref.frame(i)):
                assert a.tobytes() == b.tobytes()
        assert mine.gt_disparity(2).tobytes() == ref.gt_disparity(2).tobytes()
        np.testing.assert_array_equal(mine.gt_positions(), ref.gt_positions())
    np.testing.assert_array_equal(synthetic.stress_trajectory("sharp_turn", 12),
                                  jsyn.stress_trajectory("sharp_turn", 12))
    rng = np.random.default_rng(0)
    est = np.cumsum(rng.normal(size=(20, 3)), axis=0)
    gt = est + rng.normal(scale=0.1, size=est.shape)
    for kw in ({}, {"with_scale": True}, {"align": False}):
        assert metrics.ate_rmse(est, gt, **kw) == jmetrics.ate_rmse(est, gt, **kw)
    poses = synthetic.kitti_like_trajectory(6)
    noisy = poses.copy()
    noisy[:, :3, 3] += rng.normal(scale=0.05, size=(6, 3))
    assert metrics.rpe(noisy, poses, 2) == jmetrics.rpe(noisy, poses, 2)


def test_cross_modal_frames_are_remapped_stereo_frames():
    """A cross-modal frame is the plain stereo frame with the right image
    remapped by 255 (1 - (r / 255)^0.7), so a caller may render a stereo
    world once and remap its right images."""
    rig = synthetic.CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                              height=48, width=80)
    plain = synthetic.SyntheticStereoSequence(n_frames=2, rig=rig, seed=0, tex_size=128)
    cross = synthetic.SyntheticStereoSequence(n_frames=2, rig=rig, seed=0, tex_size=128,
                                              cross_modal=True)
    for i in range(2):
        (lp, rp), (lc, rc) = plain.frame(i), cross.frame(i)
        assert lp.tobytes() == lc.tobytes()
        assert (255.0 * (1.0 - (rp / 255.0) ** 0.7)).tobytes() == rc.tobytes()


def test_mi_match_stereo_matches_jax(world):
    seq, wire, _ = world
    cfg = jfe.MatcherConfig(max_disparity=64)
    lefts = torch.from_numpy(np.stack([w[0] for w in wire[:2]]))
    rights = torch.from_numpy(np.stack([w[1] for w in wire[:2]]))
    xy, _, v0 = tim.detect_features_grid(lefts, max_features=128)
    fr, sc, v = tfe.match_stereo(lefts, rights, xy, v0, from_reference_config(cfg), use_mi=True)
    agree = disp_ok = n_both = 0
    for i in range(2):
        jfr, jsc_, jv = (np.asarray(x) for x in jfe.match_stereo(
            jnp.asarray(wire[i][0]), jnp.asarray(wire[i][1]), jnp.asarray(xy[i].numpy()),
            jnp.asarray(v0[i].numpy()), cfg, use_mi=True))
        agree += int(np.sum(v[i].numpy() == jv))
        both = v[i].numpy() & jv
        n_both += int(both.sum())
        disp_ok += int(np.sum(np.abs(fr[i].numpy()[both, 0] - jfr[both, 0]) < 1e-3))
        # one step alone equals its row of the batch
        one = tfe.match_stereo(lefts[i], rights[i], xy[i], v0[i], from_reference_config(cfg),
                               use_mi=True)
        np.testing.assert_array_equal(one[2].numpy(), v[i].numpy())
        np.testing.assert_allclose(one[0].numpy(), fr[i].numpy(), atol=1e-4)
    assert agree >= 0.98 * 2 * 128, agree
    assert n_both > 60 and disp_ok >= 0.98 * n_both, (disp_ok, n_both)


def test_zncc_fails_cross_modal(world):
    """Negative control (tests/test_scale.py): across the modalities ZNCC
    starves or accepts garbage while the port's MI matcher finds the true
    disparities."""
    seq, wire, _ = world
    left, right = (torch.from_numpy(x) for x in wire[0])
    xy, _, v0 = tim.detect_features_grid(left, max_features=128)
    cfg = tfe.MatcherConfig(max_disparity=64)
    fr_z, _, v_zncc = tfe.match_stereo(left, right, xy, v0, cfg)
    fr_m, _, v_mi = tfe.match_stereo(left, right, xy, v0, cfg, use_mi=True)
    f = xy.numpy()
    ix = np.clip(np.round(f[:, 0]).astype(int), 0, RIG.width - 1)
    iy = np.clip(np.round(f[:, 1]).astype(int), 0, RIG.height - 1)
    d_gt = seq.gt_disparity(0)[iy, ix]
    err_z = np.abs(f[:, 0] - fr_z[:, 0].numpy() - d_gt)
    err_m = np.abs(f[:, 0] - fr_m[:, 0].numpy() - d_gt)
    vz, vm = v_zncc.numpy(), v_mi.numpy()
    assert vm.sum() > 30, vm.sum()
    assert np.median(err_m[vm]) < 1.0, np.median(err_m[vm])
    assert vz.sum() < 0.3 * vm.sum() and (vz.sum() == 0 or np.median(err_z[vz]) > 5.0)


@pytest.fixture(scope="module")
def ground_points():
    """tests/test_scale.py's stereo pair (seed 2) and ground-plane points."""
    seq = synthetic.SyntheticStereoSequence(n_frames=1, rig=RIG, seed=2)
    left, right = (x.astype(np.float32) for x in seq.frame(0))
    rng = np.random.default_rng(0)
    us, vs = rng.uniform(60, 260, 60), rng.uniform(130, 180, 60)
    z = 1.7 * RIG.fv / (vs - RIG.cv)
    pts = np.stack([(us - RIG.cu) * z / RIG.fu, (vs - RIG.cv) * z / RIG.fv, z], -1)
    return left, right, pts.astype(np.float32)


@pytest.mark.parametrize("weighting,s_gt,s0", [(False, 1.6, 1.2), (True, 1.5, 1.1)])
def test_estimate_scale_matches_jax(ground_points, weighting, s_gt, s0):
    left, right, pts_true = ground_points
    pts = pts_true / s_gt
    jcfg = jsc.ScaleConfig(intr=JINTR, baseline=RIG.baseline, weighting=weighting)
    sj, rj = jsc.estimate_scale(jnp.asarray(left), jnp.asarray(right), jnp.asarray(pts),
                                jnp.ones(60, bool), jnp.asarray(s0, jnp.float32), jcfg)
    st, rt = tsc.estimate_scale(torch.from_numpy(left), torch.from_numpy(right),
                                torch.from_numpy(pts), torch.ones(60, dtype=torch.bool), s0,
                                from_reference_config(jcfg))
    assert abs(float(st) - float(sj)) < 2e-3 * float(sj), (float(st), float(sj))
    assert abs(float(st) - s_gt) < (0.12 if weighting else 0.08)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=2e-3)


def test_estimate_scale_from_bad_init_with_coarse_search(world):
    """Cross-modal, detected corners with exact depths, the true scale 1.4
    from 0.5 and 2.8 with 13 coarse candidates: both inits solved as one
    batch of two problems, each within 6 % of the truth (the JAX test's
    bar) and within 2e-3 of JAX."""
    seq, _, _ = world
    left, right = (x.astype(np.float32) for x in seq.frame(0))
    feats, _, v0 = tim.detect_features_grid(torch.from_numpy(left), max_features=256,
                                            quality_level=1e-4)
    f = feats.numpy()
    ix = np.clip(np.round(f[:, 0]).astype(int), 0, RIG.width - 1)
    iy = np.clip(np.round(f[:, 1]).astype(int), 0, RIG.height - 1)
    d = seq.gt_disparity(0)[iy, ix]
    z = np.where(d > 1e-3, RIG.fu * RIG.baseline / np.maximum(d, 1e-3), 0.0)
    ok = v0.numpy() & (z > 2) & (z < 40)
    X = np.stack([(f[:, 0] - RIG.cu) * z / RIG.fu, (f[:, 1] - RIG.cv) * z / RIG.fv, z], -1)
    pts = (X / 1.4).astype(np.float32)
    jcfg = jsc.ScaleConfig(intr=JINTR, baseline=RIG.baseline, coarse_candidates=13)
    inits = (0.5, 2.8)
    st, rt = tsc.estimate_scale(
        torch.from_numpy(np.stack([left, left])), torch.from_numpy(np.stack([right, right])),
        torch.from_numpy(np.stack([pts, pts])), torch.from_numpy(np.stack([ok, ok])),
        torch.tensor(inits), from_reference_config(jcfg))
    for i, s0 in enumerate(inits):
        sj, _ = jsc.estimate_scale(jnp.asarray(left), jnp.asarray(right), jnp.asarray(pts),
                                   jnp.asarray(ok), jnp.asarray(s0, jnp.float32), jcfg)
        assert abs(float(st[i]) - 1.4) / 1.4 < 0.06, (s0, float(st[i]))
        assert abs(float(st[i]) - float(sj)) < 2e-3 * float(sj), (s0, float(st[i]), float(sj))


@pytest.mark.parametrize("use_lm", [True, False])
def test_lm_maximize_matches_jax(use_lm):
    """Maximize -(x-3)^2 with the reference's step sign (tests/test_scale.py
    TestLMMaximize), a batch of two starts, against JAX per start."""

    def normal_eq_t(x):
        r = x[..., 0] - 3.0
        return (2.0 * torch.ones_like(x)[..., None], (-2.0 * r)[..., None], -(r * r))

    def normal_eq_j(x):
        r = x[0] - 3.0
        return 2.0 * jnp.asarray([[1.0]]), jnp.asarray([-2.0 * r]), -(r * r)

    cfg = tlm.LMConfig(minimize=False, use_lm=use_lm, max_iter=30)
    got = tlm.lm_solve(normal_eq_t, torch.tensor([[0.0], [5.0]]), cfg)
    for i, x0 in enumerate((0.0, 5.0)):
        want = jlm.lm_solve(normal_eq_j, jnp.asarray([x0]),
                            jlm.LMConfig(minimize=False, use_lm=use_lm, max_iter=30))
        np.testing.assert_allclose(float(got.x[i, 0]), float(want.x[0]), atol=1e-6)
        assert int(got.stop[i]) == int(want.stop) and int(got.n_iter[i]) == int(want.n_iter)
        assert abs(float(got.x[i, 0]) - 3.0) < (5e-3 if use_lm else 1e-5)


def test_staged_session_matches_jax(world, jax_staged):
    """The staged session with the JAX samples injected, against JAX's
    staged engine (chunk 4, the same step keys)."""
    seq, wire, _ = world
    cfg = from_reference_config(jax_config())
    got = tcm.run_cross_modal_staged(wire, cfg, seed=0, chunk=4, device="cpu",
                                     sampler=jax_session_sampler(0, cfg.vo.n_ransac))
    want = jax_staged
    assert [r["success"] for r in got.records] == [r["success"] for r in want.records]
    assert [r["n_inliers"] for r in got.records] == [r["n_inliers"] for r in want.records]
    np.testing.assert_allclose(got.scales, want.scales, rtol=2e-3)
    np.testing.assert_allclose(got.trajectory[:, :3, :3], want.trajectory[:, :3, :3], atol=1e-3)
    np.testing.assert_allclose(got.trajectory[:, :3, 3], want.trajectory[:, :3, 3], atol=5e-3)
    ate_j = jmetrics.ate_rmse(want.trajectory[:, :3, 3], seq.gt_positions())
    ate_t = metrics.ate_rmse(got.trajectory[:, :3, 3], seq.gt_positions())
    assert abs(ate_t - ate_j) < 5e-3, (ate_t, ate_j)


def test_session_own_sampler_meets_bars_and_engines_agree(world):
    """With the port's own sampler: the JAX tests' accuracy bars, and the
    per-frame loop agrees with the staged engine (tests/test_scale.py's
    0.05 m bound; the loop warm-starts from the previous scale)."""
    seq, wire, gt_speed = world
    cfg = from_reference_config(jax_config())
    staged = tcm.run_cross_modal_staged(wire, cfg, seed=0, chunk=4, device="cpu")
    loop = tcm.run_cross_modal(wire, cfg, seed=0, device="cpu")
    for res in (staged, loop):
        assert all(r["success"] for r in res.records)
        err = _scale_errors(res, gt_speed)
        assert float(np.median(err)) < 0.02 and float(err.max()) < 0.06, err
        assert metrics.ate_rmse(res.trajectory[:, :3, 3], seq.gt_positions()) < 0.06
    dev = np.max(np.abs(staged.trajectory[:, :3, 3] - loop.trajectory[:, :3, 3]))
    assert dev < 0.05, dev
    # a staged pair of uint8 tensors is taken as it is
    ls = torch.from_numpy(np.stack([w[0] for w in wire]).astype(np.uint8))
    rs = torch.from_numpy(np.stack([w[1] for w in wire]).astype(np.uint8))
    again = tcm.run_cross_modal_staged((ls, rs), cfg, seed=0, chunk=4, device="cpu")
    np.testing.assert_array_equal(again.trajectory, staged.trajectory)


@pytest.mark.parametrize("solver", ["5point", "hybrid"])
def test_session_runs_fivepoint_and_hybrid(world, solver):
    """The session with the 5-point and hybrid mono solvers, as JAX's runs
    them (its samples from ``make_mono_samplers``: width 5 for the 5-point,
    width 8 and the stream-5 escalation for the hybrid, which escalates
    every step at ``hybrid_ratio=2.0``). A step's motion equals
    ``mono_vo_solve``'s on the same tracks and samples (that function is
    held to JAX by tests/test_torch_mono_solvers.py), and both engines
    solve the first 4 steps (64 samples each)."""
    from uasl_motion_estimation_tpu_torch.models.mono_pipeline import make_mono_samplers
    from uasl_motion_estimation_tpu_torch.models.mono_vo import mono_vo_solve

    seq, wire, gt_speed = world
    base = from_reference_config(jax_config())
    cfg = base._replace(vo=base.vo._replace(solver=solver, n_ransac=64, hybrid_ratio=2.0))
    sampler, sampler5 = make_mono_samplers(0, cfg.vo)
    prev, cur, right = (torch.from_numpy(x) for x in (wire[0][0], wire[1][0], wire[1][1]))
    out = tcm.cross_modal_step(prev, cur, right, 0, sampler, cfg, 1.0, sampler5)
    feats, _, v0 = tim.detect_features_grid(prev, max_features=cfg.max_features,
                                            quality_level=cfg.detect_quality)
    tracked = tfe.klt_track(prev, cur, feats, v0, cfg.klt)
    samples5 = sampler5(0, tracked.valid) if solver == "hybrid" else None
    res = mono_vo_solve(torch.stack([feats, tracked.pts], dim=-2), tracked.valid,
                        sampler(0, tracked.valid), cfg.vo, samples5)
    assert sampler(0, tracked.valid).shape[-1] == (5 if solver == "5point" else 8)
    assert bool(out.vo_success) and bool(res.success)
    torch.testing.assert_close(out.R, res.R, rtol=0, atol=0)
    torch.testing.assert_close(out.t, res.t, rtol=0, atol=0)
    for run in (lambda: tcm.run_cross_modal_staged(wire[:5], cfg, chunk=2, device="cpu"),
                lambda: tcm.run_cross_modal(wire[:5], cfg, device="cpu")):
        got = run()
        assert [r["success"] for r in got.records] == [True] * 4
        assert np.isfinite(got.trajectory).all() and np.isfinite(got.scales).all()


def test_entry_points_need_a_card_or_cpu(monkeypatch, world):
    """With no card and no device given, the entry points raise instead of
    running on the CPU."""
    _, wire, _ = world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.setup_device()
    cfg = from_reference_config(jax_config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcm.run_cross_modal_staged(wire[:2], cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcm.run_cross_modal(wire[:2], cfg)
    assert tdevice.setup_device("cpu").type == "cpu"
