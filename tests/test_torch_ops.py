"""Parity of the port's ops (lie, geometry, image, ZNCC cost volume, triad
alignment) with the JAX package, on inputs made with numpy from a seed.

Tolerances: pure elementwise float32 formulas agree to a few ulps (atol 1e-5
on O(1) values, rtol 1e-5 on large ones); filters and sums that XLA may
fuse or reorder get rtol 1e-5 relative to the data's scale; integer results
(argmax cells, masks) must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uasl_motion_estimation_tpu.ops import geometry as jgeo
from uasl_motion_estimation_tpu.ops import image as jim
from uasl_motion_estimation_tpu.ops import lie as jlie
from uasl_motion_estimation_tpu.ops import pnp as jpnp
from uasl_motion_estimation_tpu.ops import stereo as jst
from uasl_motion_estimation_tpu_torch.ops import geometry as tgeo
from uasl_motion_estimation_tpu_torch.ops import image as tim
from uasl_motion_estimation_tpu_torch.ops import lie as tlie
from uasl_motion_estimation_tpu_torch.ops import pnp as tpnp
from uasl_motion_estimation_tpu_torch.ops import stereo as tst

torch.set_num_threads(1)
RNG = np.random.default_rng(5)
H, W = 192, 320


def scene(h=H, w=W, seed=0):
    """Smooth random texture (box-blurred noise), uint8-range float32."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, size=(h + 8, w + 8)).astype(np.float32)
    k = np.ones(5) / 5
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 0, img)
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    img = (img[4:-4, 4:-4] - 127.5) * 4 + 127.5
    return np.clip(img, 0, 255).astype(np.float32)


def T(x):
    return torch.from_numpy(np.array(x))


def J(x):
    return jnp.asarray(np.asarray(x))


def close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# --- lie -------------------------------------------------------------------

RPY = RNG.uniform(-0.6, 0.6, (16, 3)).astype(np.float32)


def test_euler_to_R_and_back():
    close(tlie.euler_to_R(T(RPY)), jlie.euler_to_R(J(RPY)))
    R = np.asarray(jlie.euler_to_R(J(RPY)))
    close(tlie.R_to_euler(T(R)), jlie.R_to_euler(J(R)))


def test_euler_dR():
    for got, want in zip(tlie.euler_dR(T(RPY)), jlie.euler_dR(J(RPY))):
        close(got, want)


def test_skew():
    close(tlie.skew(T(RPY)), jlie.skew(J(RPY)), atol=0)


# --- geometry --------------------------------------------------------------

INTR = (320.0, 318.0, 160.0, 96.0)


def test_project_and_triangulate():
    pts = np.concatenate([RNG.uniform(-5, 5, (40, 2)), RNG.uniform(2, 40, (40, 1))],
                         -1).astype(np.float32)
    pts[0, 2] = 0.0  # the |z| < 1e-9 guard
    ti, ji = tgeo.Intrinsics(*INTR), jgeo.Intrinsics(*INTR)
    close(tgeo.project(T(pts), ti, 0.54), jgeo.project(J(pts), ji, 0.54), rtol=1e-5, atol=1e-3)
    uvl = RNG.uniform(0, 300, (40, 2)).astype(np.float32)
    uvr = uvl - np.stack([RNG.uniform(-2, 60, 40), np.zeros(40)], -1).astype(np.float32)
    close(tgeo.triangulate_disparity(T(uvl), T(uvr), ti, ti, 0.54),
          jgeo.triangulate_disparity(J(uvl), J(uvr), ji, ji, 0.54), rtol=1e-5, atol=1e-4)


# --- image -----------------------------------------------------------------

IMG = scene()


def test_pyramid_and_filters():
    tp = tim.build_pyramid(T(IMG), 4)
    jp = jim.build_pyramid(J(IMG), 4)
    for a, b in zip(tp, jp):
        assert a.shape == b.shape
        close(a, b, rtol=1e-5, atol=1e-3)
    for a, b in zip(tim.sobel(T(IMG)), jim.sobel(J(IMG))):
        close(a, b, atol=1e-3)


def test_shi_tomasi_response():
    close(tim.shi_tomasi_response(T(IMG)), jim.shi_tomasi_response(J(IMG)),
          rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("max_features,quality", [(256, 1e-4), (500, 0.01)])
def test_detect_features_grid(max_features, quality):
    txy, ts, tv = tim.detect_features_grid(T(IMG), max_features, quality)
    jxy, js, jv = jim.detect_features_grid(J(IMG), max_features, quality)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    close(txy, jxy, atol=1e-4)
    close(ts, js, rtol=1e-4, atol=1e-2)


def test_detect_features_grid_batched():
    imgs = np.stack([IMG, scene(seed=1)])
    txy, _, tv = tim.detect_features_grid(T(imgs), 128, 1e-4)
    for b in range(2):
        jxy, _, jv = jim.detect_features_grid(J(imgs[b]), 128, 1e-4)
        np.testing.assert_array_equal(tv[b].numpy(), np.asarray(jv))
        close(txy[b], jxy, atol=1e-4)


CENTERS = np.concatenate([RNG.uniform(-5, W + 5, (50, 1)), RNG.uniform(-5, H + 5, (50, 1))],
                         -1).astype(np.float32)


def test_bilinear_and_patches():
    close(tim.bilinear_sample(T(IMG), T(CENTERS)), jim.bilinear_sample(J(IMG), J(CENTERS)),
          atol=1e-3)
    close(tim.extract_patches(T(IMG), T(CENTERS), 3),
          jim.extract_patches(J(IMG), J(CENTERS), 3), atol=1e-3)
    close(tim.extract_patches_sep(T(IMG), T(CENTERS), 6),
          jim.extract_patches_sep(J(IMG), J(CENTERS), 6), atol=1e-3)


def test_sample_tiles():
    tiles = RNG.uniform(0, 255, (20, 22, 30)).astype(np.float32)
    offs = RNG.uniform(-2, 25, (20, 2)).astype(np.float32)
    close(tim.sample_tiles(T(tiles), T(offs), 11, 13),
          jim.sample_tiles(J(tiles), J(offs), 11, 13), atol=1e-3)


def test_patch_in_bounds_and_subpixel_peak():
    np.testing.assert_array_equal(tim.patch_in_bounds(T(CENTERS), 6, H, W).numpy(),
                                  np.asarray(jim.patch_in_bounds(J(CENTERS), 6, H, W)))
    p3 = RNG.normal(size=(30, 3, 3)).astype(np.float32)
    close(tim.subpixel_peak_2d(T(p3)), jim.subpixel_peak_2d(J(p3)))


# --- ZNCC cost volume ------------------------------------------------------

RIGHT = scene(seed=3)
FEATS = np.concatenate([RNG.uniform(0, W, (60, 1)), RNG.uniform(0, H, (60, 1))],
                       -1).astype(np.float32)


@pytest.mark.parametrize("prior", [False, True])
def test_zncc_disparity_scores(prior):
    """Scores in [-1, 1] from f32 cumsum moments: atol 1e-4 (the moments
    keep ~1e-5 relative precision); the -inf mask must be equal."""
    if prior:
        d0 = RNG.integers(-20, 80, 60).astype(np.int32)
        args = dict(d_offset=T(d0)), dict(d_offset=J(d0))
        width = 24
    else:
        args, width = ({}, {}), 128
    got = tst.zncc_disparity_scores(T(IMG), T(RIGHT), T(FEATS), width, 5, **args[0]).numpy()
    want = np.asarray(jst.zncc_disparity_scores(J(IMG), J(RIGHT), J(FEATS), width, 5,
                                                **args[1]))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    ok = np.isfinite(want)
    assert ok.mean() > 0.3
    close(got[ok], want[ok], atol=1e-4)


# --- triad alignment -------------------------------------------------------

def test_rigid_align_3pt():
    p = RNG.uniform(-5, 5, (32, 3, 3)).astype(np.float32)
    R = np.asarray(jlie.euler_to_R(J(RNG.uniform(-0.3, 0.3, (32, 3)).astype(np.float32))))
    q = (p @ R.transpose(0, 2, 1) + RNG.uniform(-1, 1, (32, 1, 3))).astype(np.float32)
    q[0] = q[0, :1]  # degenerate triple
    tR, tt, tok = tpnp.rigid_align_3pt(T(p), T(q))
    jR, jt, jok = jpnp.rigid_align_3pt(J(p), J(q))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    ok = np.asarray(jok)
    close(tR.numpy()[ok], np.asarray(jR)[ok], atol=1e-5)
    close(tt.numpy()[ok], np.asarray(jt)[ok], atol=1e-4)
    close(tR.numpy()[1:], R[1:], atol=1e-4)  # exact for congruent triangles


def test_jax_side_ran_on_cpu():
    assert jax.devices()[0].platform == "cpu"
