"""The port's windowed BA (``solvers/ba.py``) against the JAX reference on
synthetic windows built as ``tests/test_ba.py::make_window`` builds them,
with pixel noise and 3 % gross outliers.

Cases: stereo windows with one and two fixed frames, and the mono window
with two. A mono window with one fixed frame leaves its scale free, so the
LM path along that flat direction depends on rounding: there only what
does not depend on the scale is compared (its own test). Each JAX solve
runs once per module. Cameras and points within 1e-4
(points relative to their magnitude: mono depths reach 30 m), equal
convergence and iteration counts, cost within 1e-5 relative; the pre-BA
track gate equal; the camera covariances at JAX's solution within 1e-3 of
their largest entry (compared reassembled: eigenvectors' signs differ
between libraries); the analytic Jacobians against ``jax.jacfwd``'s,
including at the zero rotation every window's first camera has. A batch of
3 windows equals their solo solves (see the test for the precision).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_ba import BASELINE, INTR, make_window, perturb
from uasl_motion_estimation_tpu.solvers import ba as jba
from uasl_motion_estimation_tpu_torch.config import from_reference_config
from uasl_motion_estimation_tpu_torch.solvers import ba as tba

torch.set_num_threads(1)
jax_jacobians = jax.jit(jba._residuals_jacobians, static_argnames="cfg")

CASES = {  # name -> (stereo, n_fixed)
    "stereo_fixed1": (True, 1),
    "stereo_fixed2": (True, 2),
    "mono_fixed2": (False, 2),
}


def window(stereo: bool, seed: int = 7, outlier_seed: int = 21):
    """A noisy window (0.5 px) with gross outliers (30-80 px on every
    component, as tests/test_ba.py's Huber test) at one observation of each
    of 20 points seen in every frame (3 % of the observations): every point
    keeps its inlier views, so each is determined. (At 8 % the mono window's
    points run off to hundreds of metres, behind the cameras, and float32
    rounding then steers them.) Starts perturbed as tests/test_ba.py
    perturbs them."""
    cams, pts, obs, mask = make_window(noise=0.5, stereo=stereo, seed=seed)
    rng = np.random.default_rng(outlier_seed)
    full = np.nonzero(mask.all(axis=0))[0]
    ms = rng.choice(full, 20, replace=False)
    ws = rng.integers(0, mask.shape[0], len(ms))
    obs[ws, ms] += rng.uniform(30, 80, (len(ms), obs.shape[-1]))
    cams_p, pts_p = perturb(cams, pts, cam_scale=0.01 if stereo else 0.005,
                            seed=13 + seed)
    return cams_p, pts_p, obs.astype(np.float32), mask


def port_problem(*arrays) -> tba.BAProblem:
    return tba.BAProblem(*(torch.from_numpy(np.asarray(a)) for a in arrays))


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    stereo, n_fixed = CASES[request.param]
    arrays = window(stereo)
    jcfg = jba.BAConfig(intr=INTR, baseline=BASELINE if stereo else 0.0, n_fixed=n_fixed)
    jprob = jba.BAProblem(*(jnp.asarray(a) for a in arrays))
    res = jax.device_get(jba.ba_solve(jprob, jcfg))
    cov = np.asarray(jba.ba_camera_covariances(
        jprob._replace(cam=jnp.asarray(res.cam), pts=jnp.asarray(res.pts)), jcfg))
    gate = np.asarray(jba.gate_tracks(*jprob, jcfg, 3.0))
    jac = [np.asarray(x) for x in jax_jacobians(*jprob[:3], cfg=jcfg)]
    return arrays, jcfg, from_reference_config(jcfg), res, cov, gate, jac


def test_config_carries_across(case):
    _, jcfg, cfg, *_ = case
    assert isinstance(cfg, tba.BAConfig) and cfg._asdict().keys() == jcfg._asdict().keys()
    assert tuple(cfg.intr) == tuple(jcfg.intr) and cfg.n_fixed == jcfg.n_fixed


def test_solve_matches_jax(case):
    arrays, _, cfg, want, *_ = case
    got = tba.ba_solve(port_problem(*arrays), cfg)
    np.testing.assert_allclose(got.cam.numpy(), want.cam, atol=1e-4)
    pts = np.asarray(want.pts)
    np.testing.assert_allclose(got.pts.numpy(), pts, atol=1e-4 * np.abs(pts).max())
    assert bool(got.converged) == bool(want.converged)
    assert int(got.n_iter) == int(want.n_iter)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-5)


def test_jacobians_match_jax(case):
    arrays, _, cfg, *_, jac = case
    got = tba._residuals_jacobians(*port_problem(*arrays)[:3], cfg)
    for g, w in zip(got, jac, strict=True):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max())


def test_gate_and_covariances_match_jax(case):
    arrays, _, cfg, want, cov, gate, _ = case
    prob = port_problem(*arrays)
    np.testing.assert_array_equal(tba.gate_tracks(*prob, cfg, 3.0).numpy(), gate)
    solved = prob._replace(cam=torch.from_numpy(np.asarray(want.cam)),
                           pts=torch.from_numpy(np.asarray(want.pts)))
    got = tba.ba_camera_covariances(solved, cfg).numpy()
    np.testing.assert_allclose(got, cov, atol=1e-3 * np.abs(cov).max())
    assert not got[:cfg.n_fixed].any()  # the gauge frames are exactly known


def test_mono_one_fixed_frame_agrees_up_to_scale():
    """Mono, one fixed frame: the world's scale is a free direction of the
    cost, and the LM's steps along it follow rounding (measured here:
    translations 1.7e-4 apart, points 1.4e-3 m at 31 m). Convergence, the
    iteration count, the cost (1e-5 relative), the rotations (1e-4) and the
    direction of all cameras' translations taken as one vector (1e-4) do not
    depend on the scale, and must agree with JAX's."""
    arrays = window(False)
    jcfg = jba.BAConfig(intr=INTR, baseline=0.0, n_fixed=1)
    want = jax.device_get(jba.ba_solve(jba.BAProblem(*(jnp.asarray(a) for a in arrays)), jcfg))
    got = tba.ba_solve(port_problem(*arrays), from_reference_config(jcfg))
    assert bool(got.converged) and bool(want.converged)
    assert int(got.n_iter) == int(want.n_iter)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-5)
    cam, jcam = got.cam.numpy(), np.asarray(want.cam)
    np.testing.assert_allclose(cam[:, :3], jcam[:, :3], atol=1e-4)
    t, jt = cam[:, 3:].ravel(), jcam[:, 3:].ravel()
    np.testing.assert_allclose(t / np.linalg.norm(t), jt / np.linalg.norm(jt), atol=1e-4)


def test_zero_rotation_tangent_is_finite_and_matches_jax():
    _, pts, obs, _ = make_window(n_frames=1)
    cam = np.array([[0.0, 0.0, 0.0, 0.1, -0.05, 0.2]], np.float32)
    jcfg = jba.BAConfig(intr=INTR, baseline=BASELINE)
    want = [np.asarray(x) for x in jax_jacobians(jnp.asarray(cam), jnp.asarray(pts),
                                                  jnp.asarray(obs), cfg=jcfg)]
    got = tba._residuals_jacobians(torch.from_numpy(cam), torch.from_numpy(pts),
                                   torch.from_numpy(obs), from_reference_config(jcfg))
    for g, w in zip(got, want, strict=True):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batch_equals_solo_solves(dtype):
    """Three windows that converge after different numbers of iterations:
    the done latch keeps each one's state, so the batch gives each window
    its solo answer. In float64 to 1e-6; in float32 the batch's products
    reduce in another order (measured up to 2e-6 relative on the points
    after the iterations), so there the iteration counts and flags must be
    equal and the cameras within 1e-6."""
    cfg = tba.BAConfig(intr=tba.geo.Intrinsics(*INTR), baseline=BASELINE, n_fixed=1)
    probs = [port_problem(*window(True, seed=s, outlier_seed=s + 30)) for s in (7, 8, 9)]
    probs = [p._replace(cam=p.cam.to(dtype), pts=p.pts.to(dtype), obs=p.obs.to(dtype))
             for p in probs]
    solo = [tba.ba_solve(p, cfg) for p in probs]
    assert len({int(r.n_iter) for r in solo}) > 1
    batch = tba.ba_solve(tba.BAProblem(*(torch.stack(x) for x in zip(*probs))), cfg)
    for i, r in enumerate(solo):
        assert int(batch.n_iter[i]) == int(r.n_iter)
        assert bool(batch.converged[i]) == bool(r.converged)
        np.testing.assert_allclose(batch.cam[i].numpy(), r.cam.numpy(), atol=1e-6)
        if dtype == torch.float64:
            np.testing.assert_allclose(batch.pts[i].numpy(), r.pts.numpy(), atol=1e-6)
            np.testing.assert_allclose(float(batch.cost[i]), float(r.cost), rtol=1e-6)
