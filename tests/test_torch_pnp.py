"""The port's closed-form pose solvers (``ops/pnp.py``) and the ``p3p``
hypothesis solver of ``stereo_vo_solve`` against the JAX reference, on
inputs made with numpy from a seed.

Tolerances: Umeyama within 1e-5 (float32 SVD of a 3x3 covariance).
The quartic's and the resolvent cubic's roots within 1e-4 relative
wherever both sides call the root real, except at roots whose float32
value, on either side, is itself more than 1e-4 relative from the float64
root of the same float32 coefficients (near a double root the root moves
with the square root of the rounding): at most 1 % of the roots.

``p3p_grunert`` on 200 scenes: the ``ok`` masks agree on at least 95 % of
the candidates, and the best candidate of each scene recovers the true
pose (rotation entries and translation within 1e-3) in at least 95 % of
the scenes on both sides. Where both are ok, JAX's float32 candidates are
themselves within 1e-4 of the float64 solution (the port's algorithm in
float64 on the same float32 inputs) for only ~86 % of them (the depth
polish and the triad alignment amplify the quartic's rounding near
degenerate configurations), so the poses cannot be held within 1e-4 each:
the port's candidates must lie as close to the float64 solution as JAX's
(the shares within 1e-4, 1e-3 and 1e-2 at most 5 points below JAX's), its
candidates must agree with JAX's within 1e-3 for at least 95 % of them, and
each scene's best candidates within 1e-3 for at least 95 % of the scenes.
Measured: 81 % / 97 % / 99.5 % of the candidates agree within 1e-4 / 1e-3
/ 1e-2, and 83 % / 97 % / 97 % of the port's and 86 % / 97 % / 97 % of
JAX's lie that close to the float64 solution.

``stereo_vo_solve`` with ``hyp_solver="p3p"`` and JAX's samples: the same
inliers, the state within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uasl_motion_estimation_tpu.models import stereo_vo as jvo
from uasl_motion_estimation_tpu.ops import lie as jlie
from uasl_motion_estimation_tpu.ops import pnp as jpnp
from uasl_motion_estimation_tpu_torch.config import from_reference_config
from uasl_motion_estimation_tpu_torch.models import stereo_vo as tvo
from uasl_motion_estimation_tpu_torch.ops import pnp as tpnp

from test_torch_solvers import BASE, quad_matches

torch.set_num_threads(1)
N_SCENES = 200


def rotations(rng, n, scale=0.3):
    v = rng.normal(size=(n, 3)) * scale
    return np.asarray(jax.vmap(jlie.so3_exp)(jnp.asarray(v)), np.float64)


def test_rigid_align_umeyama():
    """Noisy weighted pairs, batched (4 problems of 30 points), some
    weights zero."""
    rng = np.random.default_rng(0)
    p = rng.uniform(-5, 5, (4, 30, 3))
    R = rotations(rng, 4)
    t = rng.normal(size=(4, 3))
    q = np.einsum("bij,bnj->bni", R, p) + t[:, None] + rng.normal(scale=0.01, size=p.shape)
    w = (rng.random((4, 30)) > 0.2).astype(np.float64) * rng.uniform(0.5, 2.0, (4, 30))
    p, q, w = (x.astype(np.float32) for x in (p, q, w))
    for weights in (None, w):
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else torch.from_numpy(weights)
        jR, jt = jpnp.rigid_align_umeyama(jnp.asarray(p), jnp.asarray(q), jw)
        tR, tt = tpnp.rigid_align_umeyama(torch.from_numpy(p), torch.from_numpy(q), tw)
        np.testing.assert_allclose(tR.numpy(), np.asarray(jR), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tR.numpy(), R, rtol=0, atol=1e-2)


def test_quartic_and_cubic_roots():
    """Quartics with known roots (four real, two real, none real) and random
    ones; cubics of the resolvent's form."""
    rng = np.random.default_rng(1)
    n = 300
    real = rng.uniform(-3, 3, (n, 4))
    coeffs = np.stack([np.poly(r) for r in real])  # monic, 4 real roots
    pairs = np.stack([np.poly(np.r_[r[:2], a + 1j * b, a - 1j * b]).real
                      for r, a, b in zip(real, rng.uniform(-2, 2, n), rng.uniform(0.5, 2, n))])
    rand = rng.normal(size=(n, 5))
    c = np.concatenate([coeffs, pairs, rand]).astype(np.float32)
    c = c * rng.uniform(0.5, 2.0, (c.shape[0], 1)).astype(np.float32)
    jx, jim = jpnp._solve_quartic(*(jnp.asarray(c[:, i]) for i in range(5)))
    tx, tim_ = tpnp._solve_quartic(*(torch.from_numpy(c[:, i]) for i in range(5)))
    x64, im64 = tpnp._solve_quartic(*(torch.from_numpy(c[:, i].astype(np.float64))
                                      for i in range(5)))
    jx, jim, tx, tim_ = np.asarray(jx), np.asarray(jim), tx.numpy(), tim_.numpy()
    x64 = x64.numpy()
    both = (jim == 0) & (tim_ == 0) & (im64.numpy() == 0)
    assert both[:n].mean() > 0.9  # the four-real-root quartics
    scale = 1e-4 * (1.0 + np.abs(x64[both]))
    sensitive = np.maximum(np.abs(tx[both] - x64[both]), np.abs(jx[both] - x64[both])) > scale
    assert sensitive.mean() <= 0.01, sensitive.sum()
    assert np.all(np.abs(tx[both] - jx[both])[~sensitive] <= scale[~sensitive])
    np.testing.assert_allclose(np.sort(tx[:n], axis=1), np.sort(real, axis=1), atol=5e-3)

    B, C, D = (rng.normal(size=1000).astype(np.float32) * 3 for _ in range(3))
    jr = np.asarray(jpnp._cubic_largest_real_root(*(jnp.asarray(x) for x in (B, C, D))))
    tr = tpnp._cubic_largest_real_root(*(torch.from_numpy(x) for x in (B, C, D))).numpy()
    assert np.isfinite(tr).all()
    np.testing.assert_allclose(tr, jr, rtol=1e-4, atol=1e-4)
    want = np.array([np.roots([1, b, c, d]) for b, c, d in zip(B, C, D)], dtype=complex)
    want = np.where(np.abs(want.imag) < 1e-6, want.real, -np.inf).max(axis=1)
    np.testing.assert_allclose(tr, want, rtol=1e-3, atol=1e-3)


def p3p_scenes(n=N_SCENES, seed=2):
    """Three points 10-30 m in front of a camera under random poses, and
    their unit bearings in the camera."""
    rng = np.random.default_rng(seed)
    R = rotations(rng, n)
    t = rng.normal(size=(n, 3))
    cam = np.stack([rng.uniform(-6, 6, (n, 3)), rng.uniform(-3, 3, (n, 3)),
                    rng.uniform(10, 30, (n, 3))], axis=-1)  # (n, 3 points, 3)
    world = np.einsum("nji,nkj->nki", R, cam - t[:, None])  # R^T (x - t)
    rays = cam / np.linalg.norm(cam, axis=-1, keepdims=True)
    return world.astype(np.float32), rays.astype(np.float32), R, t


def pose_err(R, t, R_ref, t_ref):
    return np.maximum(np.abs(R - R_ref).max(axis=(-2, -1)), np.abs(t - t_ref).max(axis=-1))


def recovered(R, t, ok, R_true, t_true, tol=1e-3):
    err = pose_err(R, t, R_true[:, None], t_true[:, None])
    return np.where(ok, err, np.inf).min(axis=1) < tol


def test_p3p_grunert():
    world, rays, R_true, t_true = p3p_scenes()
    jR, jt, jok = (np.asarray(x) for x in jax.vmap(jpnp.p3p_grunert)(jnp.asarray(world),
                                                                     jnp.asarray(rays)))
    tR, tt, tok = (x.numpy() for x in tpnp.p3p_grunert(torch.from_numpy(world),
                                                        torch.from_numpy(rays)))
    dR, dt, dok = (x.numpy() for x in tpnp.p3p_grunert(torch.from_numpy(world).double(),
                                                        torch.from_numpy(rays).double()))
    assert tR.shape == (N_SCENES, 4, 3, 3) and tok.shape == (N_SCENES, 4)
    assert (tok == jok).mean() >= 0.95
    both = tok & jok
    apart = pose_err(tR, tt, jR, jt)[both]
    assert (apart <= 1e-3).mean() >= 0.95, np.percentile(apart, [50, 90, 95])
    ref = both & dok
    port_exact = pose_err(tR, tt, dR, dt)[ref]
    jax_exact = pose_err(jR, jt, dR, dt)[ref]
    for tol in (1e-4, 1e-3, 1e-2):
        assert (port_exact <= tol).mean() >= (jax_exact <= tol).mean() - 0.05, tol
    assert recovered(tR, tt, tok, R_true, t_true).mean() >= 0.95
    assert recovered(jR, jt, jok, R_true, t_true).mean() >= 0.95
    best = np.where(tok, pose_err(tR, tt, R_true[:, None], t_true[:, None]), np.inf).argmin(1)
    pick = np.arange(N_SCENES), best
    assert (pose_err(tR[pick], tt[pick], jR[pick], jt[pick]) <= 1e-3).mean() >= 0.95


def test_p3p_grunert_batched_equals_each_scene():
    world, rays, *_ = p3p_scenes(n=6, seed=3)
    batched = tpnp.p3p_grunert(torch.from_numpy(world).reshape(2, 3, 3, 3),
                               torch.from_numpy(rays).reshape(2, 3, 3, 3))
    for i in range(6):
        alone = tpnp.p3p_grunert(torch.from_numpy(world[i]), torch.from_numpy(rays[i]))
        for a, b in zip(alone, batched):
            torch.testing.assert_close(a, b.reshape(6, *b.shape[2:])[i], rtol=0, atol=1e-6)


@pytest.mark.parametrize("use_lm", [False, True])
def test_stereo_vo_solve_p3p_with_jax_samples(use_lm):
    uv, valid, intr = quad_matches()
    jparams = jvo.StereoVOParams(intr1=intr, intr2=intr, baseline=BASE, hyp_solver="p3p",
                                 use_lm=use_lm, min_spread_area=200.0)
    key = jax.random.key(3)
    want = jvo.stereo_vo_solve(jnp.asarray(uv), jnp.asarray(valid), key, jparams)
    samples = np.asarray(jvo._sample_hypotheses(key, jparams.n_ransac, jnp.asarray(valid)))
    got = tvo.stereo_vo_solve(torch.from_numpy(uv), torch.from_numpy(valid), None,
                              from_reference_config(jparams),
                              samples=torch.from_numpy(np.array(samples)))
    assert bool(got.success) and bool(want.success)
    np.testing.assert_array_equal(got.inlier_mask.numpy(), np.asarray(want.inlier_mask))
    np.testing.assert_allclose(got.state.numpy(), np.asarray(want.state), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.motion.numpy(), np.asarray(want.motion), rtol=0, atol=1e-4)


def test_stereo_vo_batch_p3p_equals_each_problem():
    """stereo_vo_batch: one generator per problem, each problem as if
    solved alone."""
    probs = [quad_matches(seed=s) for s in (1, 2)]
    intr = probs[0][2]
    params = from_reference_config(jvo.StereoVOParams(intr1=intr, intr2=intr, baseline=BASE,
                                                      min_spread_area=200.0, hyp_solver="p3p"))
    uv = torch.from_numpy(np.stack([p[0] for p in probs]))
    valid = torch.from_numpy(np.stack([p[1] for p in probs]))
    batched = tvo.stereo_vo_batch(uv, valid, [torch.Generator().manual_seed(s) for s in (5, 6)],
                                  params)
    for b in range(2):
        alone = tvo.stereo_vo_solve(uv[b], valid[b], torch.Generator().manual_seed(5 + b),
                                    params)
        assert bool(alone.success) and bool(batched.success[b])
        np.testing.assert_array_equal(batched.inlier_mask[b].numpy(), alone.inlier_mask.numpy())
        np.testing.assert_allclose(batched.state[b].numpy(), alone.state.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="generators"):
        tvo.stereo_vo_batch(uv, valid, [torch.Generator()], params)
