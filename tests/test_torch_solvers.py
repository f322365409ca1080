"""Parity of the port's pose solvers with the JAX package: ``lm_solve`` (GN
and LM branches, batched with per-problem stops) and ``stereo_vo_solve``
with the JAX-drawn RANSAC samples injected.

Tolerances: stop codes, iteration counts, inlier masks and success flags
must be equal; solutions agree within 1e-5 relative to each problem's
largest parameter (float32 normal equations summed in another order), poses within 1e-4 (rotation, rad) and
1e-4 m (translation) since the VO refine stops on float32 increment tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uasl_motion_estimation_tpu.models import stereo_vo as jvo
from uasl_motion_estimation_tpu.ops import geometry as jgeo
from uasl_motion_estimation_tpu.solvers import lm as jlm
from uasl_motion_estimation_tpu_torch.config import from_reference_config
from uasl_motion_estimation_tpu_torch.models import stereo_vo as tvo
from uasl_motion_estimation_tpu_torch.solvers import lm as tlm

torch.set_num_threads(1)
RNG = np.random.default_rng(9)

# --- lm_solve on a batch of exponential curve fits -------------------------

TS = np.linspace(0.0, 3.0, 24).astype(np.float32)


def curve_problems(b=6, seed=0):
    """A batch of well-conditioned decay fits y = a exp(b t) + c; the last
    problem has no data."""
    rng = np.random.default_rng(seed)
    truth = np.stack([rng.uniform(1, 3, b), rng.uniform(-1.5, -0.5, b), rng.uniform(-1, 1, b)],
                     -1)
    y = truth[:, :1] * np.exp(truth[:, 1:2] * TS) + truth[:, 2:3]
    y = y + rng.normal(scale=0.01, size=y.shape)
    w = np.ones_like(y)
    w[-1] = 0.0  # singular normal equations
    x0 = truth + rng.uniform(-0.15, 0.15, truth.shape)
    return y.astype(np.float32), w.astype(np.float32), x0.astype(np.float32)


def jax_normal_eq(x, y, w):
    a, b, c = x[0:1], x[1:2], x[2:3]
    e = jnp.exp(b * TS)
    res = y - (a * e + c)
    Jm = jnp.stack([e, a * TS * e, jnp.ones_like(e)], axis=-1)  # (T, 3)
    JJ = (Jm * w[:, None]).T @ Jm
    Jr = (Jm * (res * w)[:, None]).sum(axis=0)
    cost = (res * res * w).sum() / jnp.maximum(w.sum(), 1.0)
    return JJ, Jr, cost


def torch_normal_eq(x, y, w):
    """The same problem, batched: x (B, 3), y and w (B, T)."""
    ts = torch.from_numpy(TS)
    a, b, c = x[:, 0:1], x[:, 1:2], x[:, 2:3]
    e = torch.exp(b * ts)
    res = y - (a * e + c)
    Jm = torch.stack([e, a * ts * e, torch.ones_like(e)], dim=-1)  # (B, T, 3)
    JJ = (Jm * w[..., None]).transpose(-1, -2) @ Jm
    Jr = (Jm * (res * w)[..., None]).sum(dim=-2)
    cost = (res * res * w).sum(dim=-1) / torch.clamp(w.sum(dim=-1), min=1.0)
    return JJ, Jr, cost


@pytest.mark.parametrize("use_lm", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_lm_solve_batched_matches_vmapped_jax(use_lm, seed):
    y, w, x0 = curve_problems(seed=seed)
    cfg = dict(max_iter=30, use_lm=use_lm, abs_tol=1e-6, grad_tol=1e-4,
               incr_tol=1e-4, rel_tol=1e-9)
    want = jax.vmap(lambda x, yy, ww: jlm.lm_solve(
        lambda s: jax_normal_eq(s, yy, ww), x, jlm.LMConfig(**cfg)))(
            jnp.asarray(x0), jnp.asarray(y), jnp.asarray(w))
    ty, tw = torch.from_numpy(y), torch.from_numpy(w)
    got = tlm.lm_solve(lambda s: torch_normal_eq(s, ty, tw), torch.from_numpy(x0),
                       tlm.LMConfig(**cfg))
    np.testing.assert_array_equal(got.stop.numpy(), np.asarray(want.stop))
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(want.n_iter))
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    want_x = np.asarray(want.x)
    scale = np.abs(want_x).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got.x.numpy() - want_x) <= 1e-5 * scale)
    # the empty problem: GN fails its singular solve; LM stops on the zero
    # gradient before it damps anything
    empty = tlm.StopCondition.SMALL_GRADIENT if use_lm else tlm.StopCondition.NO_CONVERGENCE
    assert int(got.stop[-1]) == empty
    assert len(set(got.stop.tolist())) >= 2


def test_lm_solve_max_iterations():
    y, w, x0 = curve_problems(3, seed=2)
    cfg = dict(max_iter=2, use_lm=False, abs_tol=0.0, grad_tol=0.0, incr_tol=0.0)
    ty, tw = torch.from_numpy(y[:2]), torch.from_numpy(w[:2])
    got = tlm.lm_solve(lambda s: torch_normal_eq(s, ty, tw), torch.from_numpy(x0[:2]),
                       tlm.LMConfig(**cfg))
    assert got.stop.tolist() == [tlm.StopCondition.MAX_ITERATIONS] * 2
    assert not got.success.any()


# --- stereo_vo_solve --------------------------------------------------------

INTR = (320.0, 320.0, 160.0, 96.0)
BASE = 0.54


def quad_matches(n=120, outliers=0.2, seed=0):
    """Quad matches of random points under a known motion, with pixel noise,
    outliers and invalid slots."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-6, 6, n), rng.uniform(-2, 2, n), rng.uniform(4, 40, n)], -1)
    state = np.array([0.01, -0.03, 0.02, 0.1, -0.05, 0.8])
    R = np.asarray(jax.device_get(
        jvo.lie.euler_to_R(jnp.asarray(state[:3], jnp.float32))), np.float64)
    cur = pts @ R + state[3:]
    intr = jgeo.Intrinsics(*INTR)

    def proj(p, b):
        return np.stack([INTR[0] * (p[:, 0] - b) / p[:, 2] + INTR[2],
                         INTR[1] * p[:, 1] / p[:, 2] + INTR[3]], -1)

    uv = np.stack([proj(pts, 0), proj(pts, BASE), proj(cur, 0), proj(cur, BASE)], 1)
    uv = uv + rng.normal(scale=0.3, size=uv.shape)
    bad = rng.random(n) < outliers
    uv[bad, 2:] += rng.uniform(-30, 30, (bad.sum(), 1, 2))
    valid = rng.random(n) > 0.1
    return uv.astype(np.float32), valid, intr


@pytest.mark.parametrize("hyp,use_lm", [("3pt", False), ("gn", False), ("3pt", True)])
def test_stereo_vo_solve_with_jax_samples(hyp, use_lm):
    uv, valid, intr = quad_matches()
    jparams = jvo.StereoVOParams(intr1=intr, intr2=intr, baseline=BASE, hyp_solver=hyp,
                                 use_lm=use_lm, min_spread_area=200.0)
    key = jax.random.key(3)
    want = jvo.stereo_vo_solve(jnp.asarray(uv), jnp.asarray(valid), key, jparams)
    samples = np.asarray(jvo._sample_hypotheses(key, jparams.n_ransac, jnp.asarray(valid)))
    got = tvo.stereo_vo_solve(torch.from_numpy(uv), torch.from_numpy(valid), None,
                              from_reference_config(jparams),
                              samples=torch.from_numpy(np.array(samples)))
    assert bool(got.success) and bool(want.success)
    np.testing.assert_array_equal(got.inlier_mask.numpy(), np.asarray(want.inlier_mask))
    assert int(got.n_inliers) == int(want.n_inliers)
    assert int(got.stop) == int(want.stop)
    np.testing.assert_allclose(got.state.numpy(), np.asarray(want.state), atol=1e-4)
    np.testing.assert_allclose(got.motion.numpy(), np.asarray(want.motion), atol=1e-4)
    np.testing.assert_allclose(got.mean_reproj_error.numpy(),
                               np.asarray(want.mean_reproj_error), rtol=1e-3)
    np.testing.assert_allclose(got.cov.numpy(), np.asarray(want.cov), rtol=1e-2, atol=1e-9)


def test_stereo_vo_solve_failure_contract():
    """Too few matches: no success, identity motion, the large covariance."""
    uv, valid, intr = quad_matches(n=40)
    valid[:] = False
    valid[:4] = True
    params = from_reference_config(jvo.StereoVOParams(intr1=intr, intr2=intr, baseline=BASE))
    gen = torch.Generator().manual_seed(0)
    got = tvo.stereo_vo_solve(torch.from_numpy(uv), torch.from_numpy(valid), gen, params)
    assert not bool(got.success)
    np.testing.assert_array_equal(got.motion.numpy(), np.eye(4, dtype=np.float32))
    np.testing.assert_array_equal(got.cov.numpy(), 1e2 * np.eye(6, dtype=np.float32))


def test_stereo_vo_batch_equals_each_problem():
    probs = [quad_matches(seed=s) for s in (1, 2)]
    intr = probs[0][2]
    params = from_reference_config(jvo.StereoVOParams(intr1=intr, intr2=intr, baseline=BASE,
                                                      min_spread_area=200.0))
    uv = torch.from_numpy(np.stack([p[0] for p in probs]))
    valid = torch.from_numpy(np.stack([p[1] for p in probs]))
    gens = [torch.Generator().manual_seed(s) for s in (5, 6)]
    batched = tvo.stereo_vo_solve(uv, valid, gens, params)
    for b in range(2):
        alone = tvo.stereo_vo_solve(uv[b], valid[b], torch.Generator().manual_seed(5 + b),
                                    params)
        assert bool(alone.success) and bool(batched.success[b])
        np.testing.assert_array_equal(batched.inlier_mask[b].numpy(), alone.inlier_mask.numpy())
        np.testing.assert_allclose(batched.state[b].numpy(), alone.state.numpy(), atol=1e-5)


def test_sampler_draws_valid_distinct_triples():
    valid = torch.from_numpy(RNG.random(50) > 0.5)
    s = tvo._sample_hypotheses(torch.Generator().manual_seed(1), 200, valid)
    assert s.shape == (200, 3)
    assert bool(valid[s].all())
    assert all(len(set(t)) == 3 for t in s.tolist())


def test_p3p_not_ported_yet():
    uv, valid, intr = quad_matches(n=20)
    params = from_reference_config(jvo.StereoVOParams(intr1=intr, intr2=intr, baseline=BASE,
                                                      hyp_solver="p3p"))
    with pytest.raises(NotImplementedError):
        tvo.stereo_vo_solve(torch.from_numpy(uv), torch.from_numpy(valid),
                            torch.Generator(), params)
