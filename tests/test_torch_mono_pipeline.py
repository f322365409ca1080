"""Parity of the port's monocular engine with the JAX package on the CPU:
the image operations of the top-k detector (ops/image.py), ``relative_scale``
(ops/geometry.py), ``quad_match_frames(detector="topk")`` and
models/mono_pipeline.py (``mono_sequence_scan`` with JAX's samples injected,
``run_mono_staged`` against ``MonoOdometryPipeline.run``, the batched
hybrid escalation), on the 192x320 rig.

Tolerances and why:
- filters, NMS, Harris: 1e-5 of the response scale; the same sums of
  float32 products in another order.
- ``detect_features``: the same features in the same order (ties go to the
  lower linear index on both sides) and equal masks. Sub-pixel xy within
  1e-4 px on a rendered frame: the parabola fit divides differences of
  responses that each side rounds differently (measured 3.8e-5 px, 2.5
  float32 ulps at x ~ 150); exactly equal on a response map built with
  ties.
- ``relative_scale``: 1e-6 relative; NaN where no pair is masked in.
- ``mono_sequence_scan``: equal success flags; match and inlier counts
  within one (KLT's masks can differ on a feature whose float32 residual
  sits at its threshold, tests/test_torch_frontend.py); R within 1e-5, t
  within 1e-4, relative scales within 1e-4 relative (measured: equal
  counts, 2.7e-7, 1.0e-5 and 1.7e-5).
- per-frame against staged: JAX's own contract for its two engines
  (tests/test_mono_vo.py:274-317): positions within 0.05 m, ATE < 0.12 m.
- the batched escalation against its per-step solves: equal flags and
  inlier counts, R and t within 1e-5 (float32 products of another batch
  shape; measured 3.7e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_mono import jax_mono_samples
from uasl_motion_estimation_tpu.models import frontend as jfe
from uasl_motion_estimation_tpu.models import mono_pipeline as jmp
from uasl_motion_estimation_tpu.models import mono_vo as jmv
from uasl_motion_estimation_tpu.ops import geometry as jgeo
from uasl_motion_estimation_tpu.ops import image as jim
from uasl_motion_estimation_tpu_torch.config import from_reference_config
from uasl_motion_estimation_tpu_torch.models import frontend as tfe
from uasl_motion_estimation_tpu_torch.models import mono_pipeline as tmp
from uasl_motion_estimation_tpu_torch.models import mono_vo as tmv
from uasl_motion_estimation_tpu_torch.ops import geometry as tgeo
from uasl_motion_estimation_tpu_torch.ops import image as tim
from uasl_motion_estimation_tpu_torch.utils import metrics, synthetic

torch.set_num_threads(1)
RIG = synthetic.CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                          height=192, width=320)
INTR = jgeo.Intrinsics(RIG.fu, RIG.fv, RIG.cu, RIG.cv)
N_FRAMES = 10


@pytest.fixture(scope="module")
def world():
    """tests/test_mono_vo.py's staged-vs-per-frame world: seed 3, left
    frames on the uint8 wire for both engines."""
    seq = synthetic.SyntheticStereoSequence(n_frames=N_FRAMES, rig=RIG, seed=3)
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    left = [np.clip(f[0], 0, 255).astype(np.uint8).astype(np.float32) for f in frames]
    right = [np.clip(f[1], 0, 255).astype(np.uint8).astype(np.float32) for f in frames]
    return {"left": left, "right": right, "gt": seq.gt_positions()}


def jax_cfg(**vo):
    return jmp.MonoPipelineConfig(vo=jmv.MonoVOParams(intr=INTR, inlier_threshold=2.0, **vo),
                                  max_features=256)


def close(got, want, scale=1.0, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol * scale)


def test_filters_and_nms_match_jax(world):
    img = world["left"][0]
    rng = np.random.default_rng(11)
    t_img, j_img = torch.from_numpy(img), jnp.asarray(img)
    for kernel in (np.outer([1.0, 2.0, 1.0], [-1.0, 0.0, 1.0]), rng.normal(size=(5, 5)),
                   rng.normal(size=(4, 2))):
        k = kernel.astype(np.float32)
        want = jim._conv2d_same(j_img, jnp.asarray(k))
        close(tim._conv2d_same(t_img, k), want, np.abs(want).max())
    for got, want in zip(tim.scharr(t_img), jim.scharr(j_img)):
        close(got, want, np.abs(want).max())
    want = jim.harris_response(j_img)
    close(tim.harris_response(t_img), want, np.abs(want).max())
    resp = jim.shi_tomasi_response(j_img)
    for r in (1, 5):
        want = np.asarray(jim.nms(resp, r))
        got = tim.nms(torch.from_numpy(np.array(resp)), r).numpy()
        np.testing.assert_array_equal(got, want)  # a max and a copy: exact


def test_detect_features_matches_jax(world):
    img = world["left"][0]
    xy, scores, valid = tim.detect_features(torch.from_numpy(img), 256, 0.01, 5)
    jxy, jscores, jvalid = jim.detect_features(jnp.asarray(img), 256, 0.01, 5)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert valid.sum() > 100
    close(xy, jxy, tol=1e-4)
    jscores = np.asarray(jscores)
    fin = np.isfinite(jscores)
    np.testing.assert_array_equal(np.isfinite(scores.numpy()), fin)
    close(scores.numpy()[fin], jscores[fin], np.abs(jscores[fin]).max())


def test_detect_features_breaks_ties_by_index(monkeypatch):
    """A response map with ties everywhere: equal peaks, and flat zeros that
    survive NMS and fill the rest of the budget. Both detectors get the map
    as their response (JAX's run un-jitted, so no compiled trace keeps the
    stand-in); the order of equal scores is the lower linear index first,
    and -inf pixels (border) come last, also by index."""
    h, w = 48, 80
    resp = np.zeros((h, w), np.float32)
    peaks = [(12, 60), (12, 20), (30, 40), (20, 30), (35, 12), (35, 66)]
    for i, (y, x) in enumerate(peaks):
        resp[y, x] = 1.0 if i % 2 else 0.5
    monkeypatch.setattr(jim, "shi_tomasi_response", lambda img, window_radius=2: img)
    monkeypatch.setattr(tim, "shi_tomasi_response", lambda img, window_radius=2: img)
    k = 40
    jxy, jscores, jvalid = jim.detect_features.__wrapped__(jnp.asarray(resp), k, 0.01, 5, 8)
    xy, scores, valid = tim.detect_features(torch.from_numpy(resp), k, 0.01, 5, 8)
    np.testing.assert_array_equal(xy.numpy(), np.asarray(jxy))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert valid.sum() == len(peaks)
    # the 1.0 peaks in linear-index order, then the 0.5 ones
    np.testing.assert_array_equal(xy.numpy()[:6], [[20, 12], [30, 20], [66, 35], [60, 12],
                                                   [40, 30], [12, 35]])


def test_relative_scale_matches_jax():
    rng = np.random.default_rng(12)
    a = rng.normal(size=(4, 64, 3)).astype(np.float32)
    b = (a * np.array([2.5, 0.5, 1.0, 1.7], np.float32)[:, None, None]
         + rng.normal(scale=0.05, size=a.shape)).astype(np.float32)
    mask = rng.uniform(size=(4, 64)) < 0.6
    mask[3] = False  # no pair: NaN on both sides
    got = tgeo.relative_scale(torch.from_numpy(a), torch.from_numpy(b),
                              torch.from_numpy(mask)).numpy()
    for i in range(4):
        want = float(jgeo.relative_scale(jnp.asarray(a[i]), jnp.asarray(b[i]),
                                         jnp.asarray(mask[i])))
        if i < 3:
            np.testing.assert_allclose(got[i], want, rtol=1e-6)
        else:
            assert np.isnan(want) and np.isnan(got[i])
    # an even count of pairs: the two middle ratios are averaged
    m = np.zeros(64, bool)
    m[:5] = True  # pairs 1-4
    want = float(jgeo.relative_scale(jnp.asarray(a[0]), jnp.asarray(b[0]), jnp.asarray(m)))
    got = float(tgeo.relative_scale(torch.from_numpy(a[0]), torch.from_numpy(b[0]),
                                    torch.from_numpy(m)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    want = float(jgeo.relative_scale(jnp.asarray(a[1]), jnp.asarray(b[1])))
    got = float(tgeo.relative_scale(torch.from_numpy(a[1]), torch.from_numpy(b[1])))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_quad_match_frames_topk_matches_jax(world):
    imgs = (world["left"][0], world["right"][0], world["left"][1], world["right"][1])
    kw = (("nms_radius", 5), ("quality_level", 1e-4))
    t = tfe.quad_match_frames(*(torch.from_numpy(x) for x in imgs), max_features=256,
                              detect_kwargs=kw, detector="topk")
    j = jfe.quad_match_frames(*(jnp.asarray(x) for x in imgs), max_features=256,
                              detect_kwargs=kw, detector="topk")
    tv, jv = t.valid.numpy(), np.asarray(j.valid)
    np.testing.assert_allclose(t.uv.numpy()[:, 0], np.asarray(j.uv)[:, 0], atol=1e-4)
    assert (tv == jv).mean() >= 0.98
    both = tv & jv
    assert both.sum() > 50
    np.testing.assert_allclose(t.uv.numpy()[both], np.asarray(j.uv)[both], atol=2e-3)


def jax_sampler(base, n_ransac, escalation=False):
    """The port's sampler seam fed JAX's draws for step i: the Gumbel-top-k
    samples of key fold_in(base, i) over the port's valid mask."""
    def sample(step, valid):
        key = jax.random.fold_in(base, step)
        return torch.from_numpy(jax_mono_samples(key, n_ransac, valid.numpy(),
                                                 escalation=escalation))
    return sample


def test_mono_sequence_scan_matches_jax(world):
    n, chunk = 5, 4
    cfg = jax_cfg()
    base = jax.random.key(0)
    ls = np.stack(world["left"][:n]).astype(np.uint8)
    keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(chunk))
    want = jax.device_get(jmp.mono_sequence_scan(jnp.asarray(ls), keys, cfg, chunk=chunk))
    got = tmp.mono_sequence_scan(torch.from_numpy(ls), 0, jax_sampler(base, cfg.vo.n_ransac),
                                 from_reference_config(cfg), chunk=chunk)
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    assert got.success.all()
    for k in ("n_matches", "n_inliers"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)), atol=1)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-5)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)
    np.testing.assert_allclose(got.rel_scale.numpy(), np.asarray(want.rel_scale), rtol=1e-4)


# 5-point cases solve 64 hypotheses, not 200: the port's 5-point costs
# ~1.5 s per step on one CPU thread at 200
@pytest.mark.parametrize("solver,over", [
    ("pencil8", {}),
    ("5point", {"n_ransac": 64}),
    ("hybrid", {}),
    ("hybrid", {"n_ransac": 64, "hybrid_ratio": 2.0}),  # every step escalates
], ids=["pencil8", "5point", "hybrid", "hybrid-forced"])
def test_staged_engine_matches_per_frame(world, solver, over):
    cfg = from_reference_config(jax_cfg(solver=solver, **over))
    stats = {}
    staged = tmp.run_mono_staged(world["left"], cfg, seed=0, initial_speed=0.8, chunk=3,
                                 device="cpu", stats=stats)
    loop = tmp.MonoOdometryPipeline(cfg, seed=0, initial_speed=0.8, device="cpu").run(
        world["left"])
    assert staged.shape == loop.shape == (N_FRAMES, 4, 4)
    assert all(stats["success"])
    if over.get("hybrid_ratio", 0) > 1:
        assert stats["escalated"] == list(range(N_FRAMES - 1))
    elif solver == "hybrid":
        assert stats["escalated"] == []
    dev = np.max(np.abs(staged[:, :3, 3] - loop[:, :3, 3]))
    assert dev < 0.05, dev
    for traj in (staged, loop):
        ate = metrics.ate_rmse(traj[:, :3, 3], world["gt"])
        assert ate < 0.12, ate


def test_batched_escalation_equals_per_step(world):
    """The staged scan's hybrid escalates a chunk's steps as one batch
    (hybrid_ratio 2: every step), each with its own samples: every step's
    result and escalation masks equal its solve alone."""
    cfg = from_reference_config(jax_cfg(solver="hybrid", n_ransac=48, hybrid_ratio=2.0))
    samplers = tmp.make_mono_samplers(0, cfg.vo)
    ls = torch.from_numpy(np.stack(world["left"][:6]).astype(np.uint8))
    _, steps, hyb = tmp._mono_scan(ls, 0, samplers, cfg, chunk=3)
    assert hyb["escalated"].all()
    for i, (matches, valid) in enumerate(zip(steps.matches, steps.valid)):
        stats = {}
        one = tmv.mono_vo_solve(matches, valid, samplers[0](i, valid), cfg.vo,
                                samplers[1](i, valid), stats)
        assert bool(hyb["replaced"][i]) == bool(stats["replaced"])
        assert bool(steps.result.success[i]) == bool(one.success)
        assert int(steps.result.n_inliers[i]) == int(one.n_inliers)
        np.testing.assert_allclose(steps.result.R[i].numpy(), one.R.numpy(), atol=1e-5)
        np.testing.assert_allclose(steps.result.t[i].numpy(), one.t.numpy(), atol=1e-5)


def test_mono_config_mirrors_jax():
    jc = jax_cfg(solver="hybrid")
    pc = from_reference_config(jc)
    assert isinstance(pc, tmp.MonoPipelineConfig)
    assert tmp.MonoPipelineConfig._fields == jmp.MonoPipelineConfig._fields
    assert pc._replace(vo=None, klt=None)._asdict() == jc._replace(vo=None, klt=None)._asdict()
    assert pc.klt._asdict() == jc.klt._asdict()
    assert tmp.MonoScanOutput._fields == jmp.MonoScanOutput._fields
    assert tmp.MonoFrameOutput._fields == jmp.MonoFrameOutput._fields
