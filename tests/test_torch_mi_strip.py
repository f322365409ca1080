"""The MI matcher's strip route and K2's strip mode, on the CPU.

The port's MI matcher samples one (k, D + 2r) right strip per feature and
scores its D disparity windows with K2's strip mode (``kernels.mi.mi_strip``)
instead of sampling D separate patches. These tests hold it to the old
per-candidate route and to the JAX package:

- ids: the strip's windows equal the per-candidate patches bit for bit at
  every candidate inside the image (each coordinate is one float32 addition
  of an integer, so both routes round the same real number);
- scores: the JAX cost volume (``models/frontend.py``'s MI branch, with the
  Pallas kernel in interpret mode) at 1e-5 absolute, -inf at the same
  candidates: the ids are the same, so only the final float32 sums differ;
- the plain strip mode equals the plain pair mode on the unfolded windows;
- the sparse-count identity the CUDA kernel sums, in float64;
- the matcher makes no per-candidate patch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uasl_motion_estimation_tpu.ops import image as jim
from uasl_motion_estimation_tpu.ops import similarity as jsim
from uasl_motion_estimation_tpu_torch.models import frontend as tfe
from uasl_motion_estimation_tpu_torch.ops import image as tim
from uasl_motion_estimation_tpu_torch.ops import similarity as tsim
from uasl_motion_estimation_tpu_torch.ops.kernels import mi as kmi
from uasl_motion_estimation_tpu_torch.utils import synthetic

torch.set_num_threads(1)
ATOL = 1e-5
H, W = 48, 80
N_FEAT, N_DISP, R = 32, 32, 5
K = 2 * R + 1


@pytest.fixture(scope="module")
def world():
    """Two cross-modal steps of a 48x80 world (uint8 wire values) and 32
    seeded float features per step anywhere in the image."""
    rig = synthetic.CameraRig(fu=80.0, fv=80.0, cu=40.0, cv=24.0, baseline=0.54,
                              height=H, width=W)
    seq = synthetic.SyntheticStereoSequence(n_frames=2, rig=rig, seed=4, tex_size=128,
                                            cross_modal=True)
    frames = [seq.frame(i) for i in range(2)]
    wire = [[np.clip(x, 0, 255).astype(np.uint8).astype(np.float32) for x in f] for f in frames]
    lefts = np.stack([f[0] for f in wire])
    rights = np.stack([f[1] for f in wire])
    rng = np.random.default_rng(0)
    feats = np.stack([rng.uniform(0, W, (2, N_FEAT)), rng.uniform(0, H, (2, N_FEAT))],
                     -1).astype(np.float32)
    feats[:, :8, 0] = rng.uniform(R + N_DISP, W - R - 2, (2, 8))  # all D candidates inside
    return lefts, rights, feats


def _candidates(feats):
    x, y = feats[..., 0], feats[..., 1]
    d = torch.arange(N_DISP, dtype=torch.float32)
    return torch.stack([x[..., None] - d, y[..., None].expand(*x.shape, N_DISP)], -1)


def test_strip_ids_equal_per_candidate_ids(world):
    lefts, rights, feats = world
    right, f = torch.from_numpy(rights), torch.from_numpy(feats)
    cand = _candidates(f)
    per_cand = tim.extract_patches(right, cand.flatten(-3, -2), R).reshape(
        2, N_FEAT, N_DISP, K, K)
    strips = tim.extract_strips(right, f, R, N_DISP)
    assert strips.shape == (2, N_FEAT, K, N_DISP + 2 * R)
    windows = kmi.strip_windows(strips.reshape(-1, K, N_DISP + 2 * R), K).reshape(
        2, N_FEAT, N_DISP, K, K)
    inside = tim.patch_in_bounds(cand, R + 1, H, W)
    assert int(inside.sum()) > 0.3 * inside.numel()
    assert torch.equal(windows[inside], per_cand[inside])  # the samples, bit for bit
    ids_strip = tsim.quantise(windows)
    ids_cand = tsim.quantise(per_cand)
    assert torch.equal(ids_strip[inside], ids_cand[inside])


@pytest.mark.parametrize("use_pallas", [None, False])
def test_strip_scores_match_jax_cost_volume(world, use_pallas):
    """The port's (2, N, D) MI volume against JAX's per-candidate volume,
    built as ``models/frontend.py``'s MI branch builds it, per step."""
    lefts, rights, feats = world
    cfg = tfe.MatcherConfig(max_disparity=N_DISP, use_pallas=use_pallas)
    got = tfe._mi_disparity_scores(torch.from_numpy(lefts), torch.from_numpy(rights),
                                   torch.from_numpy(feats), cfg).numpy()
    assert got.shape == (2, N_FEAT, N_DISP)
    for i in range(2):
        f = jnp.asarray(feats[i])
        d_range = jnp.arange(N_DISP, dtype=jnp.float32)
        cand = jnp.stack([f[:, None, 0] - d_range[None, :],
                          jnp.broadcast_to(f[:, None, 1], (N_FEAT, N_DISP))], -1)
        pl = jim.extract_patches(jnp.asarray(lefts[i]), f, R)
        pr = jim.extract_patches(jnp.asarray(rights[i]), cand.reshape(-1, 2), R).reshape(
            N_FEAT, N_DISP, K, K)
        ok = jim.patch_in_bounds(cand, R + 1, H, W)
        scores = jsim.mutual_information_batched(pl[:, None], pr, bins=20, use_pallas=True)
        want = np.asarray(jnp.where(ok, scores, -jnp.inf))
        np.testing.assert_array_equal(np.isneginf(got[i]), np.isneginf(want))
        fin = np.isfinite(want)
        assert fin.sum() > 0.3 * fin.size
        np.testing.assert_allclose(got[i][fin], want[fin], atol=ATOL)


@pytest.mark.parametrize("k,n_disp,bins", [(11, 32, 20), (9, 16, 32), (3, 1, 4)])
def test_strip_plain_equals_pairs_on_windows(k, n_disp, bins):
    """mi_strip (CPU: its plain version) against mi_pairs_plain on windows
    cut out of the strip one by one: window d is columns [D-1-d, D-1-d+k)."""
    rng = np.random.default_rng(k * 100 + n_disp)
    n_feat = 5
    qa = rng.integers(0, bins, (n_feat, k * k)).astype(np.uint8)
    strip = rng.integers(0, bins, (n_feat, k, n_disp + k - 1)).astype(np.uint8)
    strip[1] = strip[1, :, :1]  # a flat strip: every window the same
    windows = np.stack([strip[:, :, n_disp - 1 - d:n_disp - 1 - d + k]
                        for d in range(n_disp)], 1).reshape(n_feat * n_disp, k * k)
    want = kmi.mi_pairs_plain(torch.from_numpy(qa.astype(np.int32)),
                              torch.from_numpy(windows.astype(np.int32)), n_disp, k * k,
                              bins).reshape(n_feat, n_disp)
    ta, ts = torch.from_numpy(qa), torch.from_numpy(strip)
    np.testing.assert_array_equal(kmi.mi_strip_plain(ta, ts, bins).numpy(), want.numpy())
    np.testing.assert_array_equal(kmi.mi_strip(ta, ts, bins).numpy(), want.numpy())


def _pixel_sum_mi(qa, qb, bins, n_valid):
    """float64 MI as the CUDA kernel sums it: over counted pixels p,
    log2(n c(p) / (ca(p) cb(p))) / n, with the counts of p's own cell."""
    out = []
    for a, b in zip(qa, qb):
        keep = (a >= 0) & (a < bins) & (b >= 0) & (b < bins)
        a, b = a[keep], b[keep]
        cell = np.zeros((bins, bins), np.int64)
        np.add.at(cell, (a, b), 1)
        c, ca, cb = cell[a, b], cell.sum(1)[a], cell.sum(0)[b]
        out.append(np.sum(np.log2(n_valid * c / (ca * cb))) / n_valid)
    return np.array(out)


@pytest.mark.parametrize("bins,sentinel", [(20, None), (32, None), (20, 25)])
def test_sparse_count_identity(bins, sentinel):
    """Sum over pixels of log2 c(p) equals sum over cells of c log2 c: the
    kernel's per-pixel sum against the per-cell MI in float64, and against
    the one-hot MI (JAX's and the port's, float32) and K2's plain version."""
    rng = np.random.default_rng(bins)
    qa = rng.integers(0, bins, (40, 121))
    qb = np.minimum(qa + rng.integers(0, 3, qa.shape), bins - 1)  # dependent pairs
    qb[::4] = rng.integers(0, bins, (10, 121))  # and independent ones
    qb[5] = 3  # one flat patch
    n_valid = 121
    if sentinel is not None:
        qa[::3, -7:] = sentinel
    got = _pixel_sum_mi(qa, qb, bins, n_valid)
    cell_mi = []
    for a, b in zip(qa, qb):
        keep = (a < bins) & (b < bins)
        pj = np.zeros((bins, bins))
        np.add.at(pj, (a[keep], b[keep]), 1.0 / n_valid)
        pa, pb = pj.sum(1, keepdims=True), pj.sum(0, keepdims=True)
        nz = pj > 0
        cell_mi.append(np.sum(pj[nz] * np.log2(pj[nz] / (pa * pb)[nz])))
    np.testing.assert_allclose(got, np.array(cell_mi), rtol=0, atol=1e-12)
    plain = kmi.mi_pairs_plain(torch.from_numpy(qa.astype(np.int32)),
                               torch.from_numpy(qb.astype(np.int32)), 1, n_valid, bins)
    np.testing.assert_allclose(plain.numpy(), got, atol=ATOL)
    if sentinel is None:  # the one-hot MI has no sentinels
        fa = (qa * 256.0 / bins + 0.5).astype(np.float32).reshape(-1, 11, 11)
        fb = (qb * 256.0 / bins + 0.5).astype(np.float32).reshape(-1, 11, 11)
        one_hot_j = np.asarray(jsim.mutual_information(jnp.asarray(fa), jnp.asarray(fb), bins))
        one_hot_t = tsim.mutual_information(torch.from_numpy(fa), torch.from_numpy(fb),
                                            bins).numpy()
        np.testing.assert_allclose(one_hot_j, got, atol=ATOL)
        np.testing.assert_allclose(one_hot_t, got, atol=ATOL)


def test_matcher_makes_no_per_candidate_patch(world, monkeypatch):
    """match_stereo(use_mi=True) samples N patches and N strips, never N x D
    patches: every bilinear sample call stays below N * D * k * k points,
    extract_patches never gets N * D centres, and K2 runs once, in strip
    mode."""
    lefts, rights, feats = world
    centres, samples, modes = [], [], []
    extract_patches, bilinear_sample = tim.extract_patches, tim.bilinear_sample
    mi_strip, mi_pairs = kmi.mi_strip, kmi.mi_pairs

    def counting_patches(img, c, radius):
        centres.append(c[..., 0].numel())
        return extract_patches(img, c, radius)

    def counting_sample(img, xy):
        samples.append(xy[..., 0].numel())
        return bilinear_sample(img, xy)

    def counting_strip(*a, **kw):
        modes.append("strip")
        return mi_strip(*a, **kw)

    def counting_pairs(*a, **kw):
        modes.append("pairs")
        return mi_pairs(*a, **kw)

    monkeypatch.setattr(tim, "extract_patches", counting_patches)
    monkeypatch.setattr(tim, "bilinear_sample", counting_sample)
    monkeypatch.setattr(kmi, "mi_strip", counting_strip)
    monkeypatch.setattr(kmi, "mi_pairs", counting_pairs)
    cfg = tfe.MatcherConfig(max_disparity=N_DISP)
    valid = torch.ones((2, N_FEAT), dtype=torch.bool)
    fr, _, v = tfe.match_stereo(torch.from_numpy(lefts), torch.from_numpy(rights),
                                torch.from_numpy(feats), valid, cfg, use_mi=True)
    assert fr.shape == (2, N_FEAT, 2) and v.any()
    assert modes == ["strip"]
    assert centres and max(centres) == 2 * N_FEAT
    assert samples and sum(samples) < 2 * N_FEAT * N_DISP * K * K
    assert sum(samples) == 2 * N_FEAT * K * (K + N_DISP + 2 * R)


def test_mi_strip_rejects_bad_input():
    qa = torch.zeros((4, 121), dtype=torch.uint8)
    strip = torch.zeros((4, 11, 20), dtype=torch.uint8)
    assert kmi.mi_strip(qa, strip).shape == (4, 10)
    with pytest.raises(TypeError):
        kmi.mi_strip(qa.to(torch.int32), strip)
    with pytest.raises(ValueError):
        kmi.mi_strip(qa[:3], strip)
    with pytest.raises(ValueError):
        kmi.mi_strip(qa, strip[:, :, :10])  # narrower than k
    with pytest.raises(ValueError):
        kmi.mi_strip(qa, strip, bins=33)
    with pytest.raises(ValueError):
        kmi.mi_strip(torch.zeros((4, 289), dtype=torch.uint8),
                     torch.zeros((4, 17, 20), dtype=torch.uint8))  # k * k above 256
    with pytest.raises(ValueError):  # ids must lie in [0, bins)
        kmi.mi_strip(qa, torch.full((4, 11, 20), 20, dtype=torch.uint8))
    meta = torch.zeros((4, 11, 20), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):  # no kernel and no fallback off the CPU
        kmi.mi_strip(qa.to("meta"), meta)
