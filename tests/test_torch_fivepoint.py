"""Parity of the port's exact 5-point solver (ops/fivepoint.py) with the JAX
package, on the CPU, and the solver's own contract.

JAX compiles ``fivepoint_candidates`` once (~27 s on the CPU) and runs it on
each of the 30 scenes of ``tests/test_fivepoint.py``'s ``_scene`` (seeds
0-29); every test shares that fixture.

The nullspace basis is not unique: JAX's and torch's SVDs return different
orthonormal bases of the same 4-dim null space, and the basis fixes the
parametrisation E = x E1 + y E2 + z E3 + E4, hence the roots, their order
and which ones the grid brackets. So:

- with JAX's basis injected into ``candidates_from_basis``, the two sides
  run the same algorithm on the same numbers. det M(z) is a float32 10x10
  determinant, and where it is within rounding of zero at a grid node (far
  out on the tan grid, or between two close roots) its sign, and so a
  bracket, can differ between two float32 evaluation orders. Measured on
  the 30 scenes: equal masks in 28; between the 123 candidates both sides
  keep there, a median difference of 4.6e-5 per entry of a unit-norm E,
  84 % within 1e-3, at most 0.146 (at roots that float32 moves on either
  side). Held: masks in at least 27 scenes, the median below 1e-4, at
  least 75 % within 1e-3;
- with its own basis, the port's candidates are the same essential
  matrices as JAX's (up to sign and order) except where one
  parametrisation's roots fall outside the other's search range or into
  one bracket: of the 263 candidates of both sides, 84 % are found by the
  other side within 1e-2; held at 80 %. The contract of
  ``tests/test_fivepoint.py`` holds as there: epipolar residual and |det E|
  below 5e-3 on seeds 0-4 (measured 6.0e-4 and 1.7e-8), the true E among
  the candidates in at least 25 of 30 scenes (measured 26).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_fivepoint import _rot, _scene
from uasl_motion_estimation_tpu.ops import fivepoint as jfp
from uasl_motion_estimation_tpu_torch.ops import fivepoint as tfp

torch.set_num_threads(1)
N_SCENES = 30


def jax_basis(p1, p2):
    """The basis JAX's ``_fivepoint_impl`` takes: rows 5-8 of the SVD's V^T
    of the same 5x9 system."""
    x1, y1, x2, y2 = p1[:, 0], p1[:, 1], p2[:, 0], p2[:, 1]
    A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, jnp.ones_like(x1)], -1)
    return jnp.linalg.svd(A, full_matrices=True)[2][5:9].reshape(4, 3, 3)


@pytest.fixture(scope="module")
def scenes():
    x1, x2, E = (np.stack(a) for a in zip(*(_scene(s) for s in range(N_SCENES))))
    basis = np.array(jax.jit(jax.vmap(jax_basis))(x1, x2))
    candidates = jax.jit(jfp.fivepoint_candidates)  # per scene: vmap traces slower
    Es, valid = (np.stack(a) for a in zip(*(jax.device_get(candidates(a, b))
                                            for a, b in zip(x1, x2))))
    return {"x1": x1, "x2": x2, "E_true": E, "basis": basis, "jE": Es, "jvalid": valid}


def sign_dist(A, B):
    """Max-entry distance between essential matrices, up to sign."""
    return np.minimum(np.abs(A - B).max((-2, -1)), np.abs(A + B).max((-2, -1)))


def test_candidates_from_jax_basis_match_jax(scenes):
    Es, valid = tfp.candidates_from_basis(torch.from_numpy(scenes["basis"]))
    Es, valid = Es.numpy(), valid.numpy()
    jE, jv = scenes["jE"], scenes["jvalid"]
    assert Es.shape == (N_SCENES, 10, 3, 3)
    same_mask = (valid == jv).all(axis=1)
    assert same_mask.sum() >= 27, np.nonzero(~same_mask)[0]
    both = valid & jv & same_mask[:, None]
    d = sign_dist(Es, jE)[both]
    assert np.median(d) < 1e-4, np.median(d)
    assert (d < 1e-3).mean() >= 0.75, np.sort(d)[-10:]


def test_own_basis_finds_jax_candidates(scenes):
    Es, valid = tfp.fivepoint_candidates(torch.from_numpy(scenes["x1"]),
                                         torch.from_numpy(scenes["x2"]))
    Es, valid = Es.numpy(), valid.numpy()
    found = []
    for s in range(N_SCENES):
        mine, theirs = Es[s][valid[s]], scenes["jE"][s][scenes["jvalid"][s]]
        for a, b in ((mine, theirs), (theirs, mine)):
            found += [bool(len(b)) and sign_dist(b, e).min() < 1e-2 for e in a]
    assert np.mean(found) >= 0.8, np.mean(found)


def test_own_basis_meets_contract(scenes):
    """tests/test_fivepoint.py's constraint test on seeds 0-4, and its
    true-E recovery over all 30 scenes."""
    Es, valid = tfp.fivepoint_candidates(torch.from_numpy(scenes["x1"]),
                                         torch.from_numpy(scenes["x2"]))
    Es, valid = Es.numpy().astype(np.float64), valid.numpy()
    for s in range(5):
        assert valid[s].any()
        h1 = np.c_[scenes["x1"][s], np.ones(5)]
        h2 = np.c_[scenes["x2"][s], np.ones(5)]
        for E in Es[s][valid[s]]:
            assert np.abs(np.einsum("ni,ij,nj->n", h2, E, h1)).max() < 5e-3
            assert abs(np.linalg.det(E)) < 5e-3
            EEt = E @ E.T
            assert np.abs(2.0 * EEt @ E - np.trace(EEt) * E).max() < 2e-2
    hits = sum(bool(valid[s].any()) and sign_dist(Es[s][valid[s]], scenes["E_true"][s]).min()
               < 1e-2 for s in range(N_SCENES))
    assert hits >= 25, hits


def test_batched_over_leading_dims(scenes):
    """A (2, 3) batch of samples gives what the flat batch gives."""
    x1 = torch.from_numpy(scenes["x1"][:6])
    x2 = torch.from_numpy(scenes["x2"][:6])
    Ef, vf = tfp.fivepoint_candidates(x1, x2)
    Eb, vb = tfp.fivepoint_candidates(x1.reshape(2, 3, 5, 2), x2.reshape(2, 3, 5, 2))
    assert Eb.shape == (2, 3, 10, 3, 3) and vb.shape == (2, 3, 10)
    np.testing.assert_array_equal(vb.reshape(6, 10).numpy(), vf.numpy())
    np.testing.assert_allclose(Eb.reshape(6, 10, 3, 3).numpy(), Ef.numpy(), atol=1e-6)


def test_pure_rotation_stays_finite():
    """t = 0: the solver must not emit non-finite candidates where valid."""
    rng = np.random.default_rng(0)
    R = _rot([0.2, 1.0, 0.1], 0.15)
    X = rng.uniform(-2, 2, size=(5, 3))
    X[:, 2] = rng.uniform(4, 10, size=5)
    x1 = (X[:, :2] / X[:, 2:3]).astype(np.float32)
    X2 = X @ R.T
    x2 = (X2[:, :2] / X2[:, 2:3]).astype(np.float32)
    Es, valid = tfp.fivepoint_candidates(torch.from_numpy(x1), torch.from_numpy(x2))
    assert torch.isfinite(Es[valid]).all()


def test_det_unrolled_and_constraints_match_jax(scenes):
    """det_unrolled against JAX's on random 10x10 matrices, with pivot ties
    (equal |entries| in a column: the first one wins on both sides) and a
    singular matrix; _M_of_z against JAX's on the scenes' bases. 1e-5 of
    the scale: float32 products in another order."""
    rng = np.random.default_rng(5)
    M = rng.normal(size=(64, 10, 10)).astype(np.float32)
    M[1, :, 0] = 1.0  # every row ties for the first pivot
    M[2, 3:, 1] = -M[2, 3:, 1].max()
    M[3, 4] = M[3, 2]  # singular
    got = tfp.det_unrolled(torch.from_numpy(M)).numpy()
    want = np.asarray(jax.jit(jfp.det_unrolled)(M))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got, np.linalg.det(M.astype(np.float64)), rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    z = np.linspace(-3.0, 3.0, N_SCENES).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        jM = np.asarray(jax.jit(jax.vmap(jfp._M_of_z))(scenes["basis"], z))
    tM = tfp._M_of_z(torch.from_numpy(scenes["basis"]), torch.from_numpy(z)[:, None])[:, 0]
    np.testing.assert_allclose(tM.numpy(), jM, atol=1e-5 * np.abs(jM).max())
