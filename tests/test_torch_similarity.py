"""Parity of the port's patch similarity (ops/similarity.py) and of the plain
version of kernel K2 (ops/kernels/mi.py) with the JAX package, on the CPU.

K2's JAX side is the Pallas kernel in interpret mode (``mi_quantized_pairs``
/ ``mutual_information_pallas``, ``interpret=True``) and the one-hot
``sim.mutual_information``; the cases mirror tests/test_pallas_mi.py. The
ids are the same on both sides, so the histograms are exact and only the
final float32 sum rounds: tolerance 1e-5 absolute (MI values are 0-5 bits).
The float patch measures (entropy, NCC, ZNCC) are held to 1e-5 as well.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uasl_motion_estimation_tpu.ops import similarity as jsim
from uasl_motion_estimation_tpu.ops.pallas.mi import mi_quantized_pairs, mutual_information_pallas
from uasl_motion_estimation_tpu_torch.ops import similarity as tsim
from uasl_motion_estimation_tpu_torch.ops.kernels import mi as kmi

torch.set_num_threads(1)
ATOL = 1e-5


def _uniform(rng, shape):
    return rng.uniform(0, 255, shape).astype(np.float32)


def _both(fn_j, fn_t, *arrays):
    want = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays)))
    got = fn_t(*(torch.from_numpy(a) for a in arrays)).numpy()
    return got, want


def test_matches_pallas_kernel_and_one_hot():
    rng = np.random.default_rng(5)
    a, b = _uniform(rng, (37, 11, 11)), _uniform(rng, (37, 11, 11))
    got = tsim.mutual_information_batched(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    pallas = np.asarray(mutual_information_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    one_hot = np.asarray(jsim.mutual_information(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    np.testing.assert_allclose(got, one_hot, atol=ATOL)


def test_identical_patches_give_entropy():
    a = _uniform(np.random.default_rng(6), (5, 11, 11))
    ta = torch.from_numpy(a)
    got = tsim.mutual_information_batched(ta, ta).numpy()
    np.testing.assert_allclose(got, tsim.entropy(ta).numpy(), atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(jsim.entropy(jnp.asarray(a))), atol=ATOL)


def test_independent_patches_near_zero():
    rng = np.random.default_rng(7)
    a = np.tile(_uniform(rng, (1, 16, 16)), (3, 1, 1))
    b = _uniform(rng, (3, 16, 16))
    got = tsim.mutual_information_batched(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    same = tsim.mutual_information_batched(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    assert (got < 0.5 * same).all()
    pallas = np.asarray(mutual_information_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    np.testing.assert_allclose(got, pallas, atol=ATOL)


@pytest.mark.parametrize("shape_a,shape_b", [
    ((6, 1, 9, 9), (6, 5, 9, 9)),  # the MI matcher's cost volume: rep = D
    ((2, 6, 1, 9, 9), (2, 6, 5, 9, 9)),  # with a step dim in front
    ((1, 9, 9), (4, 9, 9)),  # one patch against many
    ((6, 5, 9, 9), (6, 1, 9, 9)),  # broadcast on the other side: expanded
])
def test_router_broadcasts_like_jax(shape_a, shape_b):
    rng = np.random.default_rng(8)
    a, b = _uniform(rng, shape_a), _uniform(rng, shape_b)
    got = tsim.mutual_information_batched(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jsim.mutual_information_batched(jnp.asarray(a), jnp.asarray(b),
                                                      use_pallas=True))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    one_hot = tsim.mutual_information_batched(torch.from_numpy(a), torch.from_numpy(b),
                                              use_pallas=False).numpy()
    np.testing.assert_allclose(one_hot, want, atol=ATOL)


@pytest.mark.parametrize("sentinel", [20, 25, 31, 400])
def test_sentinel_anywhere_above_bins(sentinel):
    """An id outside [0, bins) drops its pixel, also when it lands inside
    the Pallas kernel's 32-sublane packing; normalised by n_valid."""
    rng = np.random.default_rng(0)
    npix = 121
    qa = rng.integers(0, 20, (9, npix)).astype(np.int32)
    qb = rng.integers(0, 20, (9, npix)).astype(np.int32)
    pad = 128 - npix
    qa_p = np.pad(qa, ((0, 0), (0, pad)), constant_values=sentinel)
    qb_p = np.pad(qb, ((0, 0), (0, pad)), constant_values=0)
    want = np.asarray(mi_quantized_pairs(jnp.asarray(qa_p), jnp.asarray(qb_p), n_valid=npix,
                                         interpret=True))
    got = kmi.mi_pairs(torch.from_numpy(qa_p), torch.from_numpy(qb_p), n_valid=npix).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the sentinel in qb instead: dropped the same way
    got_b = kmi.mi_pairs(torch.from_numpy(qb_p), torch.from_numpy(qa_p), n_valid=npix).numpy()
    want_b = np.asarray(jsim.mutual_information(
        jnp.asarray((qb * 256.0 / 20 + 0.5).astype(np.float32).reshape(9, 11, 11)),
        jnp.asarray((qa * 256.0 / 20 + 0.5).astype(np.float32).reshape(9, 11, 11))))
    np.testing.assert_allclose(got_b, want_b, atol=ATOL)


@pytest.mark.parametrize("p,bins", [(81, 20), (121, 20), (121, 32), (81, 32)])
def test_plain_kernel_matches_one_hot_with_rep(p, bins):
    """K2's plain version with ``rep`` against the JAX one-hot MI of the
    expanded pairs, at both patch sizes and both bin counts of the card
    checks."""
    rng = np.random.default_rng(p + bins)
    qa = rng.integers(0, bins, (5, p)).astype(np.int32)
    qb = rng.integers(0, bins, (5 * 4, p)).astype(np.int32)
    got = kmi.mi_pairs(torch.from_numpy(qa), torch.from_numpy(qb), rep=4, bins=bins).numpy()
    k = int(np.sqrt(p))
    fa = (np.repeat(qa, 4, axis=0) * 256.0 / bins + 0.5).astype(np.float32).reshape(-1, k, k)
    fb = (qb * 256.0 / bins + 0.5).astype(np.float32).reshape(-1, k, k)
    want = np.asarray(jsim.mutual_information(jnp.asarray(fa), jnp.asarray(fb), bins))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_batch_shapes():
    rng = np.random.default_rng(9)
    a, b = _uniform(rng, (4, 7, 9, 9)), _uniform(rng, (4, 7, 9, 9))
    got = tsim.mutual_information_batched(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (4, 7)
    pallas = np.asarray(mutual_information_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, atol=ATOL)


@pytest.mark.parametrize("name", ["quantise", "histogram", "entropy"])
def test_single_patch_measures(name):
    a = _uniform(np.random.default_rng(10), (3, 11, 11))
    got, want = _both(getattr(jsim, name), getattr(tsim, name), a)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("name", ["joint_histogram", "mutual_information", "ncc", "zncc"])
def test_pair_measures(name):
    rng = np.random.default_rng(11)
    a, b = _uniform(rng, (3, 11, 11)), _uniform(rng, (3, 11, 11))
    got, want = _both(getattr(jsim, name), getattr(tsim, name), a, b)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_kernel_wrapper_rejects_bad_input():
    q = torch.zeros((4, 121), dtype=torch.int32)
    with pytest.raises(TypeError):
        kmi.mi_pairs(q.to(torch.int64), q)
    with pytest.raises(ValueError):
        kmi.mi_pairs(q, torch.zeros((5, 121), dtype=torch.int32), rep=1)
    with pytest.raises(ValueError):
        kmi.mi_pairs(q, q, bins=33)
    with pytest.raises(ValueError):
        kmi.mi_pairs(q, torch.zeros((121, 4), dtype=torch.int32).t())
    meta = torch.zeros((4, 121), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):  # no kernel and no fallback off the CPU
        kmi.mi_pairs(meta, meta)
    with pytest.raises(ValueError):  # the one-hot path is for CPU tensors only
        tsim.mutual_information_batched(meta.float().reshape(4, 11, 11),
                                        meta.float().reshape(4, 11, 11), use_pallas=False)
