"""The port's stitching (``parallel/stitching.py``) against JAX's on the same
inputs, its properties (tests/test_parallel.py:140-197), and the covariance
circuit on rendered frames (tests/test_parallel.py:199-261).

Against JAX (float32, one process): ``_se3_log``/``_se3_exp``,
``align_overlap`` (uniform and weighted), ``weights_from_covariances``,
``overlap_weights_np`` and ``stitch_segments`` (exact, noisy, weighted)
within 1e-5. Properties: exact segments stitch to the truth within 1e-4;
segments with 1 cm of noise per frame stitch within 0.15 m; with one
overlap candidate per boundary corrupted and its covariance saying so, the
weighted stitch's worst position error is below 5 % of the uniform one's.
Circuit: the port's ``vo_step`` covariances, chained by
``chain_covariances_np``, weight the overlap frame before a destroyed frame
more than 1e2 times the frames after it.
"""

import numpy as np
import pytest
import torch

from uasl_motion_estimation_tpu_torch.models.pipeline import default_config, make_sampler, vo_step
from uasl_motion_estimation_tpu_torch.ops import lie
from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
from uasl_motion_estimation_tpu_torch.parallel import stitching
from uasl_motion_estimation_tpu_torch.utils import synthetic

torch.set_num_threads(1)


def make_segments(s=4, f=8, overlap=2, noise=0.0, seed=0):
    """A trajectory cut into overlapping segments, each re-gauged to its own
    first frame (and, with ``noise``, each frame but the first moved by
    that many metres): (segments (S, F, 4, 4) float32, truth (N, 4, 4))."""
    rng = np.random.default_rng(seed)
    n = s * (f - overlap) + overlap
    gt = []
    pose = np.eye(4)
    for _ in range(n):
        T = np.eye(4)
        T[:3, :3] = lie.so3_exp(torch.from_numpy(rng.normal(scale=0.02, size=3)
                                                 .astype(np.float32))).numpy()
        T[:3, 3] = [0.1, 0, 0.8]
        pose = pose @ T
        gt.append(pose.copy())
    gt = np.stack(gt)
    segs = []
    for si in range(s):
        start = si * (f - overlap)
        chunk = gt[start:start + f].copy()
        chunk = np.linalg.inv(chunk[0]) @ chunk
        if noise:
            for k in range(1, f):
                d = np.eye(4)
                d[:3, 3] = rng.normal(scale=noise, size=3)
                chunk[k] = chunk[k] @ d
        segs.append(chunk)
    return np.stack(segs).astype(np.float32), gt


def degraded_segments():
    """make_segments() with the second overlap frame of each next segment
    moved by 0.5 m, and covariances that say so: (segments, weights, truth)."""
    segs, gt = make_segments(s=4, f=8, overlap=2)
    rng = np.random.default_rng(5)
    covs_prev = np.tile(np.eye(6) * 1e-6, (3, 2, 1, 1))
    covs_next = np.tile(np.eye(6) * 1e-6, (3, 2, 1, 1))
    for b in range(3):
        d = np.eye(4)
        d[:3, 3] = rng.normal(scale=0.5, size=3)
        segs[b + 1, 1] = segs[b + 1, 1] @ d
        covs_next[b, 1] = np.eye(6)
    w = np.stack([stitching.overlap_weights_np(covs_prev[b], covs_next[b]) for b in range(3)])
    return segs, w.astype(np.float32), gt


def random_poses(n, seed):
    rng = np.random.default_rng(seed)
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = lie.so3_exp(torch.from_numpy(rng.normal(scale=0.3, size=(n, 3))
                                                .astype(np.float32))).numpy()
    T[:, :3, 3] = rng.normal(scale=2.0, size=(n, 3))
    return T


@pytest.fixture(scope="module")
def jst():
    from uasl_motion_estimation_tpu.parallel import stitching as jax_stitching

    return jax_stitching


def test_se3_log_exp_match_jax(jst):
    import jax.numpy as jnp

    T = random_poses(16, 1)
    xi = stitching._se3_log(torch.from_numpy(T)).numpy()
    np.testing.assert_allclose(xi, np.asarray(jst._se3_log(jnp.asarray(T))), atol=1e-5)
    np.testing.assert_allclose(stitching._se3_exp(torch.from_numpy(xi)).numpy(),
                               np.asarray(jst._se3_exp(jnp.asarray(xi))), atol=1e-5)
    np.testing.assert_allclose(stitching._se3_exp(torch.from_numpy(xi)).numpy(), T, atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_align_overlap_matches_jax(jst, weighted):
    import jax.numpy as jnp

    segs, _ = make_segments(noise=0.01, seed=3)
    prev, nxt = segs[0, -3:], segs[1, :3]
    w = np.array([1.0, 0.2, 3.0], np.float32) if weighted else None
    got = stitching.align_overlap(torch.from_numpy(prev), torch.from_numpy(nxt),
                                  None if w is None else torch.from_numpy(w)).numpy()
    want = jst.align_overlap(jnp.asarray(prev), jnp.asarray(nxt),
                             None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_weights_match_jax(jst):
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    a = rng.normal(size=(5, 6, 6)).astype(np.float32)
    covs = a @ np.swapaxes(a, 1, 2) * np.float32(1e-3)
    got = stitching.weights_from_covariances(torch.from_numpy(covs)).numpy()
    np.testing.assert_allclose(got, np.asarray(jst.weights_from_covariances(jnp.asarray(covs))),
                               rtol=1e-5)
    w = stitching.weights_from_covariances(torch.stack([torch.eye(6) * 1e-4,
                                                        torch.eye(6) * 1e2])).numpy()
    assert w[0] > 1e3 * w[1]
    np.testing.assert_allclose(stitching.overlap_weights_np(covs[:3], covs[2:]),
                               jst.overlap_weights_np(covs[:3], covs[2:]), rtol=1e-12)


@pytest.mark.parametrize("case", ["exact", "noisy", "weighted"])
def test_stitch_segments_matches_jax(jst, case):
    import jax.numpy as jnp

    w = None
    if case == "exact":
        segs, _ = make_segments()
    elif case == "noisy":
        segs, _ = make_segments(noise=0.01, seed=3)
    else:
        segs, w, _ = degraded_segments()
    got = stitching.stitch_segments(torch.from_numpy(segs), 2,
                                    None if w is None else torch.from_numpy(w)).numpy()
    want = np.asarray(jst.stitch_segments(jnp.asarray(segs), overlap=2,
                                          overlap_weights=None if w is None else jnp.asarray(w)))
    assert got.shape == want.shape == (26, 4, 4)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_exact_segments_stitch_exactly():
    segs, gt = make_segments()
    out = stitching.stitch_segments(torch.from_numpy(segs), overlap=2).numpy()
    want = np.linalg.inv(gt[0]) @ gt
    assert out.shape == want.shape
    np.testing.assert_allclose(out, want, atol=1e-4)


def test_noisy_overlap_fuses():
    segs, gt = make_segments(noise=0.01, seed=3)
    out = stitching.stitch_segments(torch.from_numpy(segs), overlap=2).numpy()
    want = np.linalg.inv(gt[0]) @ gt
    err = np.linalg.norm(out[:, :3, 3] - want[:, :3, 3], axis=-1)
    assert err.max() < 0.15, err.max()


def test_weighted_stitching_beats_uniform_on_degraded_overlap():
    segs, w, gt = degraded_segments()
    want = np.linalg.inv(gt[0]) @ gt
    out_u = stitching.stitch_segments(torch.from_numpy(segs), overlap=2).numpy()
    out_w = stitching.stitch_segments(torch.from_numpy(segs), overlap=2,
                                      overlap_weights=torch.from_numpy(w)).numpy()
    err_u = np.linalg.norm(out_u[:, :3, 3] - want[:, :3, 3], axis=-1)
    err_w = np.linalg.norm(out_w[:, :3, 3] - want[:, :3, 3], axis=-1)
    assert err_w.max() < 0.05 * err_u.max(), (err_w.max(), err_u.max())


def test_prefix_products_equal_the_serial_product():
    x = torch.from_numpy(random_poses(13, 4)).double()
    want, acc = [], torch.eye(4, dtype=torch.float64)
    for m in x:
        acc = acc @ m
        want.append(acc)
    torch.testing.assert_close(stitching.prefix_products(x), torch.stack(want), rtol=0,
                               atol=1e-9)


def test_covariance_circuit_end_to_end_degraded_frames():
    """The port's per-motion VO covariances, chained per segment, make the
    overlap weights discriminate a photometrically destroyed overlap frame
    by orders of magnitude (two 6-frame segments sharing 3 frames)."""
    rig = synthetic.CameraRig(fu=200.0, fv=200.0, cu=80.0, cv=48.0, baseline=0.5,
                              height=96, width=160)
    f, ov = 6, 3
    n = 2 * f - ov
    seq = synthetic.SyntheticStereoSequence(n_frames=n, rig=rig, seed=6)
    frames = [list(map(np.asarray, seq.frame(i))) for i in range(n)]
    rng = np.random.default_rng(9)
    mid = f - ov + 1  # the middle overlap frame
    for cam in (0, 1):
        frames[mid][cam] = np.clip(frames[mid][cam] * 0.15
                                   + rng.normal(scale=60.0, size=frames[mid][cam].shape), 0, 255)
    cfg = default_config(Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline,
                         image_shape=(96, 160))._replace(max_features=128)
    sampler = make_sampler(0, cfg.vo.n_ransac)

    def run_segment(start):
        motions, covs, succ = [], [], []
        for i in range(start, start + f - 1):
            out = vo_step(*(torch.from_numpy(np.asarray(x, np.float32))
                            for x in (*frames[i], *frames[i + 1])), 100 + i, sampler, cfg)
            ok = bool(out.success)
            motions.append(out.motion.numpy().astype(np.float64) if ok else np.eye(4))
            covs.append(out.cov.numpy().astype(np.float64))
            succ.append(ok)
        return stitching.chain_covariances_np(motions, covs), succ

    c0, succ0 = run_segment(0)
    c1, succ1 = run_segment(f - ov)
    assert not (succ0[mid - 1] and succ0[mid]) or not (succ1[mid - 1 - (f - ov)]
                                                       and succ1[mid - (f - ov)])
    w = stitching.overlap_weights_np(c0[f - ov:], c1[:ov])
    assert w[0] > 1e2 * w[1], w
    assert w[0] > 1e2 * w[2], w
    assert np.trace(c0[f - ov]) + np.trace(c1[0]) < 1e-2
