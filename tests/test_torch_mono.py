"""Parity of the port's mono-VO stack with the JAX package, on the CPU:
ops/smallalg.py (Jacobi eigh, 3x3 SVD), the so3_exp / homogeneous helpers,
and models/mono_vo.py's ``mono_vo_solve`` with the JAX-drawn RANSAC samples
injected.

Tolerances and why:
- eigh/SVD: 1e-5 of the matrix scale. Both sides run the same fixed Jacobi
  sweeps in float32; only the order of the float32 products differs.
- mono_vo_solve: equal success flags, equal inlier masks, R, t and E
  within 1e-4. The same samples make the same hypotheses; the RANSAC vote is
  discrete, and float32 rounding in the 9x9 Jacobi moves E by ~1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_mono_vo import INTR, make_two_view
from uasl_motion_estimation_tpu.models import mono_vo as jmv
from uasl_motion_estimation_tpu.ops import geometry as jgeo
from uasl_motion_estimation_tpu.ops import lie as jlie
from uasl_motion_estimation_tpu.ops import smallalg as jsa
from uasl_motion_estimation_tpu_torch.config import from_reference_config
from uasl_motion_estimation_tpu_torch.models import mono_vo as tmv
from uasl_motion_estimation_tpu_torch.ops import geometry as tgeo
from uasl_motion_estimation_tpu_torch.ops import lie as tlie
from uasl_motion_estimation_tpu_torch.ops import smallalg as tsa

torch.set_num_threads(1)
RNG = np.random.default_rng(3)


def jax_mono_samples(key, n_ransac: int, valid: np.ndarray, k: int = 8,
                     escalation: bool = False) -> np.ndarray:
    """The (n_ransac, k) Gumbel-top-k draw of the JAX ``_mono_vo_impl``:
    k = 8 for the pencil, 5 for the 5-point. ``escalation``: the hybrid's
    5-point draw, from ``fold_in(key, 5)`` with k = 5."""
    if escalation:
        key, k = jax.random.fold_in(key, 5), 5
    v = jnp.asarray(valid)

    def one(kk):
        g = jnp.where(v, jax.random.gumbel(kk, v.shape), -jnp.inf)
        return jax.lax.top_k(g, k)[1]

    return np.array(jax.vmap(one)(jax.random.split(key, n_ransac)))  # a writable copy


@pytest.mark.parametrize("n,b", [(3, 64), (4, 128), (9, 32), (10, 16)])
def test_eigh_jacobi_matches_jax(n, b):
    A = RNG.normal(size=(b, n, n)).astype(np.float32)
    A = A @ np.swapaxes(A, 1, 2)
    wj, Vj = jsa.eigh_jacobi(jnp.asarray(A))
    wt, Vt = tsa.eigh_jacobi(torch.from_numpy(A))
    scale = np.abs(A).max()
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-5 * scale)
    np.testing.assert_allclose(Vt.numpy(), np.asarray(Vj), atol=1e-4)


def test_round_robin_equals_jax():
    for n in (3, 4, 9, 10):
        assert tsa._round_robin_rounds(n) == jsa._round_robin_rounds(n)


def test_equal_diagonal_pair_and_skew_svd():
    """The sgn(0) := +1 rule: exactly equal diagonal entries still rotate
    by 45 degrees, and the SVD of skew((1, 1, 0)/sqrt(2)) comes out right."""
    A = np.array([[0.5, -0.5, 0.0], [-0.5, 0.5, 0.0], [0.0, 0.0, 1.0]], np.float32)[None]
    w, V = tsa.eigh_jacobi(torch.from_numpy(A))
    np.testing.assert_allclose(w.numpy()[0], [0.0, 1.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(np.einsum("bij,bj,bkj->bik", V.numpy(), w.numpy(), V.numpy()),
                               A, atol=1e-6)
    t = np.array([1.0, 1.0, 0.0]) / np.sqrt(2.0)
    E = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]], np.float32)[None]
    U, s, Vt = tsa.svd3_rotation(torch.from_numpy(E))
    np.testing.assert_allclose(s.numpy()[0], [1.0, 1.0, 0.0], atol=1e-5)
    np.testing.assert_allclose(np.einsum("bij,bj,bjk->bik", U.numpy(), s.numpy(), Vt.numpy()),
                               E, atol=1e-4)
    for got, want in zip((U, s, Vt), jsa.svd3_rotation(jnp.asarray(E))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_svd3_matches_jax():
    E = RNG.normal(size=(64, 3, 3)).astype(np.float32)
    for got, want in zip(tsa.svd3_rotation(torch.from_numpy(E)),
                         jsa.svd3_rotation(jnp.asarray(E))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_svd3_rank2_essential_case():
    """Singular values (1, 1, 0): the leading singular vectors are unique
    only up to a rotation in their plane, which rounding picks, so the
    factors are held to the reconstruction and the singular values. The
    zero one is the square root of an eigenvalue at float32 rounding
    (~1e-8), so it carries ~1e-4 of noise: 1e-3, the JAX test's bound."""
    E = RNG.normal(size=(64, 3, 3)).astype(np.float32)
    U, s, Vt = np.linalg.svd(E)
    s[:, 2], s[:, :2] = 0.0, 1.0
    E = np.einsum("bij,bj,bjk->bik", U, s, Vt).astype(np.float32)
    Ut, st, Vtt = (x.numpy() for x in tsa.svd3_rotation(torch.from_numpy(E)))
    sj = np.asarray(jsa.svd3_rotation(jnp.asarray(E))[1])
    np.testing.assert_allclose(st, sj, atol=1e-3)
    assert np.abs(st[:, 2]).max() < 1e-3
    np.testing.assert_allclose(np.einsum("bij,bj,bjk->bik", Ut, st, Vtt), E, atol=2e-3)
    np.testing.assert_allclose(np.einsum("bji,bjk->bik", Ut, Ut),
                               np.broadcast_to(np.eye(3), E.shape), atol=1e-4)


def test_so3_exp_and_homogeneous_match_jax():
    v = np.concatenate([RNG.normal(size=(16, 3)), 1e-6 * RNG.normal(size=(4, 3)),
                        np.zeros((1, 3))]).astype(np.float32)
    np.testing.assert_allclose(tlie.so3_exp(torch.from_numpy(v)).numpy(),
                               np.asarray(jlie.so3_exp(jnp.asarray(v))), atol=1e-6)
    p = RNG.normal(size=(5, 7, 3)).astype(np.float32)
    p[0, 0, 2], p[0, 1, 2] = 0.0, -1e-14
    np.testing.assert_array_equal(tgeo.to_homogeneous(torch.from_numpy(p)).numpy(),
                                  np.asarray(jgeo.to_homogeneous(jnp.asarray(p))))
    np.testing.assert_allclose(tgeo.from_homogeneous(torch.from_numpy(p)).numpy(),
                               np.asarray(jgeo.from_homogeneous(jnp.asarray(p))), rtol=1e-6)


def _outlier_world(seed=3, n_bad=40):
    matches, R, t, _ = make_two_view(noise=0.3, seed=seed)
    rng = np.random.default_rng(9)
    bad = rng.choice(len(matches), n_bad, replace=False)
    matches[bad, 1] += rng.uniform(20, 120, (n_bad, 2)).astype(np.float32)
    valid = np.ones(len(matches), bool)
    valid[:5] = False
    return matches, valid


# each JAX configuration compiles for ~25 s on the CPU: the default one is
# shared with the batched test, and pencil=False with LMedS runs port-only
@pytest.mark.parametrize("robust,pencil", [("ransac", True), ("ransac", False),
                                           ("lmeds", True)])
def test_mono_vo_solve_matches_jax(robust, pencil):
    matches, valid = _outlier_world()
    jp = jmv.MonoVOParams(intr=INTR, robust=robust, pencil=pencil)
    key = jax.random.key(1)
    want = jmv.mono_vo_solve(jnp.asarray(matches), jnp.asarray(valid), key, jp)
    samples = jax_mono_samples(key, jp.n_ransac, valid)
    got = tmv.mono_vo_solve(torch.from_numpy(matches), torch.from_numpy(valid),
                            torch.from_numpy(samples), from_reference_config(jp))
    assert bool(got.success) == bool(want.success)
    np.testing.assert_array_equal(got.inlier_mask.numpy(), np.asarray(want.inlier_mask))
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)
    np.testing.assert_allclose(got.E.numpy(), np.asarray(want.E), atol=1e-4)
    np.testing.assert_allclose(got.Rt.numpy(), np.asarray(want.Rt), atol=1e-4)


def test_mono_vo_plain_lmeds_recovers_motion():
    matches, R, t, _ = make_two_view(noise=0.3, seed=3)
    valid = np.ones(len(matches), bool)
    p = tmv.MonoVOParams(intr=from_reference_config(INTR), robust="lmeds", pencil=False)
    samples = jax_mono_samples(jax.random.key(2), p.n_ransac, valid)
    got = tmv.mono_vo_solve(torch.from_numpy(matches), torch.from_numpy(valid),
                            torch.from_numpy(samples), p)
    assert bool(got.success)
    np.testing.assert_allclose(got.R.numpy(), R, atol=1.5e-2)
    np.testing.assert_allclose(got.t.numpy(), t / np.linalg.norm(t), atol=5e-2)


def test_mono_vo_batched_equals_single_and_jax():
    """A leading batch of problems solves each as it would alone. Points
    are compared within the 50-unit cheirality cap: far points come from
    a near-degenerate DLT nullspace that magnifies float32 rounding."""
    worlds = [make_two_view(seed=0)[0], make_two_view(seed=1, rotvec=(0.02, -0.01, 0.0))[0],
              _outlier_world(seed=4)[0]]
    M = np.stack(worlds)
    V = np.ones(M.shape[:2], bool)
    p = tmv.MonoVOParams(intr=from_reference_config(INTR))
    samples = np.stack([jax_mono_samples(jax.random.key(i), p.n_ransac, V[i])
                        for i in range(len(worlds))])
    batch = tmv.mono_vo_solve(torch.from_numpy(M), torch.from_numpy(V),
                              torch.from_numpy(samples), p)
    for i in range(len(worlds)):
        one = tmv.mono_vo_solve(torch.from_numpy(M[i]), torch.from_numpy(V[i]),
                                torch.from_numpy(samples[i]), p)
        want = jmv.mono_vo_solve(jnp.asarray(M[i]), jnp.asarray(V[i]), jax.random.key(i),
                                 jmv.MonoVOParams(intr=INTR))
        np.testing.assert_array_equal(batch.inlier_mask[i].numpy(), one.inlier_mask.numpy())
        np.testing.assert_allclose(batch.R[i].numpy(), one.R.numpy(), atol=1e-6)
        np.testing.assert_allclose(batch.R[i].numpy(), np.asarray(want.R), atol=1e-4)
        near = np.abs(one.pts3d.numpy()[:, 2]) < 50.0
        np.testing.assert_allclose(batch.pts3d[i].numpy()[near], one.pts3d.numpy()[near],
                                   rtol=1e-4, atol=1e-4)


def test_too_few_matches_fails_like_jax():
    matches, *_ = make_two_view()  # the batched test's shape: one JAX compile
    valid = np.zeros(len(matches), bool)
    valid[:5] = True
    key = jax.random.key(0)
    want = jmv.mono_vo_solve(jnp.asarray(matches), jnp.asarray(valid), key,
                             jmv.MonoVOParams(intr=INTR))
    got = tmv.mono_vo_solve(torch.from_numpy(matches), torch.from_numpy(valid),
                            torch.from_numpy(jax_mono_samples(key, 200, valid)),
                            tmv.MonoVOParams(intr=from_reference_config(INTR)))
    assert not bool(want.success) and not bool(got.success)


@pytest.mark.parametrize("overrides,k,with5", [
    ({"solver": "7point"}, 8, False),  # unknown solver
    ({"robust": "huber"}, 8, False),  # unknown robust scoring
    ({"solver": "5point"}, 8, False),  # 8-point samples given to the 5-point
    ({"solver": "hybrid"}, 8, False),  # the hybrid without its 5-point samples
])
def test_unknown_options_raise(overrides, k, with5):
    matches, *_ = make_two_view(n=20)
    samples5 = torch.zeros((4, 5), dtype=torch.int64) if with5 else None
    with pytest.raises(ValueError):
        tmv.mono_vo_solve(torch.from_numpy(matches), torch.ones(20, dtype=torch.bool),
                          torch.zeros((4, k), dtype=torch.int64),
                          tmv.MonoVOParams(intr=from_reference_config(INTR), **overrides),
                          samples5)


def test_mono_params_mirror_jax_defaults():
    jp = jmv.MonoVOParams(intr=INTR)
    assert from_reference_config(jp)._asdict() == {
        **jp._asdict(), "intr": from_reference_config(INTR)}
    assert tmv.MonoVOParams._fields == jmv.MonoVOParams._fields
