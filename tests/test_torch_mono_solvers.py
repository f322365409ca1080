"""Parity of the port's ``mono_vo_solve`` with ``solver="5point"`` and
``"hybrid"`` against the JAX package on the CPU, with JAX's samples injected.

The worlds are ``tests/test_mono_vo.py``'s hybrid test: 200 two-view
matches, 0.3 px noise, a share of them replaced by uniform outliers; 40
hypotheses, a 2 px threshold. At 10 % outliers the pencil succeeds and the
hybrid must not escalate; at 65 % the pencil collapses, the hybrid must
escalate and keep the 5-point solution.

JAX's 5-point solve is compiled once (about 55 s of tracing and compiling
on the CPU) and called per world with the key ``fold_in(key, 5)``: that is
JAX's hybrid escalation, whose output is its 5-point solve's wherever it
escalates (JAX's own hybrid, which also traces the pencil, costs twice as
much to compile). ``jax_mono_samples`` reproduces both of JAX's draws. The
port's 5-point is held to JAX's on every world; the hybrid's decision and
winner are held on the port's side: its pencil decides (as JAX's test
expects at each rate), it equals its 5-point where it escalates and its
pencil bit for bit where it does not. The port's pencil is held to JAX's
by tests/test_torch_mono.py.

Tolerances: equal success flags and inlier counts; R and t within 1e-4
(measured at most 1.1e-5 here). The samples are the same, but the
5-point's candidates carry float32 root noise that differs between the two
sides (tests/test_torch_fivepoint.py); the winning hypothesis's support is
refitted and polished, which washes it out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_mono_vo import INTR, make_two_view
from tests.test_torch_mono import jax_mono_samples
from uasl_motion_estimation_tpu.models import mono_vo as jmv
from uasl_motion_estimation_tpu_torch.config import from_reference_config
from uasl_motion_estimation_tpu_torch.models import mono_vo as tmv

torch.set_num_threads(1)
N, H = 200, 40
WORLDS = [(0.10, 0), (0.10, 1), (0.65, 0), (0.65, 1), (0.65, 2), (0.65, 3)]
JP = jmv.MonoVOParams(intr=INTR, inlier_threshold=2.0, solver="hybrid", n_ransac=H)


def outlier_world(rate: float, seed: int):
    """tests/test_mono_vo.py's breakdown world."""
    matches, R, t, _ = make_two_view(noise=0.3, seed=seed)
    rng = np.random.default_rng(1000 + seed)
    nbad = int(rate * N)
    bad = rng.choice(N, nbad, replace=False)
    matches[bad, 1] = np.stack([rng.uniform(0, 640, nbad), rng.uniform(0, 480, nbad)],
                               -1).astype(np.float32)
    return matches, R


@pytest.fixture(scope="module")
def worlds():
    out = []
    valid = np.ones(N, bool)
    jp5 = JP._replace(solver="5point")
    for rate, seed in WORLDS:
        matches, R = outlier_world(rate, seed)
        key = jax.random.key(seed)
        want5 = jax.device_get(jmv.mono_vo_solve(jnp.asarray(matches), jnp.asarray(valid),
                                                 jax.random.fold_in(key, 5), jp5))
        out.append({"rate": rate, "matches": matches, "valid": valid, "R_true": R,
                    "want5": want5, "samples": jax_mono_samples(key, H, valid),
                    "samples5": jax_mono_samples(key, H, valid, escalation=True)})
    return out


def solve(w, solver: str, stats=None, **over) -> tmv.MonoVOResult:
    p = from_reference_config(JP)._replace(solver=solver, **over)
    samples = w["samples5"] if solver == "5point" else w["samples"]
    return tmv.mono_vo_solve(torch.from_numpy(w["matches"]), torch.from_numpy(w["valid"]),
                             torch.from_numpy(samples), p, torch.from_numpy(w["samples5"]),
                             stats)


def assert_same(got: tmv.MonoVOResult, want, atol=1e-4):
    assert bool(got.success) == bool(want.success)
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=atol)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=atol)


def rot_err_deg(R, R_true) -> float:
    c = (np.trace(np.asarray(R, np.float64).T @ R_true) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


@pytest.mark.parametrize("i", range(len(WORLDS)))
def test_hybrid_matches_jax(worlds, i):
    """The port's 5-point equals JAX's (its hybrid's escalation) on every
    world. The hybrid escalates exactly where the pencil collapses (65 %
    outliers) and there keeps the 5-point solution, which recovers the
    rotation within 1 degree; elsewhere it is the pencil's solution."""
    w = worlds[i]
    five = solve(w, "5point")
    assert_same(five, w["want5"])
    stats = {}
    hyb = solve(w, "hybrid", stats)
    p8 = solve(w, "pencil8")
    need5 = bool((p8.n_inliers < JP.hybrid_ratio * N) | ~p8.success)
    assert need5 == (w["rate"] > 0.5) == bool(stats["escalated"])
    if need5:
        assert bool(tmv.hybrid_take5(five.success, five.n_inliers, p8.success, p8.n_inliers))
        assert bool(stats["replaced"])
        assert_same(hyb, w["want5"])
        for a, b in zip(hyb, five):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert rot_err_deg(five.R.numpy(), w["R_true"]) < 1.0
    else:
        for a, b in zip(hyb, p8):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_hybrid_batch_equals_each_problem(worlds):
    """All worlds in one batch (the escalated ones picked with one host
    read, solved together and scattered back) give each world's solve."""
    stack = {k: torch.from_numpy(np.stack([w[k] for w in worlds]))
             for k in ("matches", "valid", "samples", "samples5")}
    p = from_reference_config(JP)
    batch = tmv.mono_vo_solve(stack["matches"], stack["valid"], stack["samples"], p,
                              stack["samples5"])
    for i, w in enumerate(worlds):
        one = solve(w, "hybrid")
        assert bool(batch.success[i]) == bool(one.success)
        np.testing.assert_array_equal(batch.inlier_mask[i].numpy(), one.inlier_mask.numpy())
        np.testing.assert_allclose(batch.R[i].numpy(), one.R.numpy(), atol=1e-6)
        np.testing.assert_allclose(batch.t[i].numpy(), one.t.numpy(), atol=1e-6)
