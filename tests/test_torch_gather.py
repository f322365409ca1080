"""Parity of the port's tile gather (kernel K1) with the JAX package.

On the CPU the port's ``extract_tiles`` runs K1's plain PyTorch version; it is
held against JAX ``extract_tiles`` (its XLA branch, the oracle of the Pallas
kernel) and against the Pallas kernel itself in interpret mode, at the cases
of ``tests/test_pallas_kernels.py``. The output is a copy of image values, so
the tolerance is exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uasl_motion_estimation_tpu.ops import image as jim
from uasl_motion_estimation_tpu.ops.pallas.gather import gather_rects
from uasl_motion_estimation_tpu_torch.ops import image as tim
from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg

torch.set_num_threads(1)
RNG = np.random.default_rng(11)


def image(h=120, w=200):
    return RNG.uniform(0, 255, size=(h, w)).astype(np.float32)


def port_tiles(img, anchors, th, tw=None):
    return tim.extract_tiles(torch.from_numpy(img), torch.from_numpy(anchors), th, tw).numpy()


@pytest.mark.parametrize("th,tw", [(16, 22), (11, 138), (22, 22), (14, 18), (1, 1)])
def test_random_and_negative_anchors(th, tw):
    img = image()
    anchors = np.stack([RNG.integers(-160, 360, 60), RNG.integers(-40, 170, 60)],
                       -1).astype(np.int32)
    got = port_tiles(img, anchors, th, tw)
    want = np.asarray(jim.extract_tiles(jnp.asarray(img), jnp.asarray(anchors), th, tw))
    assert got.shape == (60, th, tw)
    np.testing.assert_array_equal(got, want)


def test_matches_pallas_kernel_interpret():
    img = image()
    anchors = np.stack([RNG.integers(-10, 210, 40), RNG.integers(-10, 130, 40)],
                       -1).astype(np.int32)
    got = port_tiles(img, anchors, 16, 22)
    want = gather_rects(jnp.asarray(img), jnp.asarray(anchors), 16, 22, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_edge_clamping():
    img = np.arange(48, dtype=np.float32).reshape(6, 8)
    anchors = np.array([[-3, -3], [6, 4], [100, 100], [-100, 2],
                        [2**31 - 1, -2**31]], np.int32)
    got = port_tiles(img, anchors, 4, 4)
    want = np.asarray(jim.extract_tiles(jnp.asarray(img), jnp.asarray(anchors), 4))
    np.testing.assert_array_equal(got, want)


def test_batched_leading_dims():
    imgs = np.stack([image(64, 96), image(64, 96)])
    anchors = np.stack([RNG.integers(-5, 90, (2, 9)), RNG.integers(-5, 60, (2, 9))],
                       -1).astype(np.int32)
    got = port_tiles(imgs, anchors, 8, 10)
    want = jax.vmap(lambda i, a: jim.extract_tiles(i, a, 8, 10))(
        jnp.asarray(imgs), jnp.asarray(anchors))
    assert got.shape == (2, 9, 8, 10)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("bad", ["dtype_img", "dtype_anchor", "shape", "lead", "strided"])
def test_wrapper_rejects_bad_inputs(bad):
    img = torch.zeros(2, 10, 12)
    anc = torch.zeros(2, 3, 2, dtype=torch.int32)
    if bad == "dtype_img":
        img = img.double()
    elif bad == "dtype_anchor":
        anc = anc.long()
    elif bad == "shape":
        anc = torch.zeros(2, 3, 3, dtype=torch.int32)
    elif bad == "lead":
        anc = torch.zeros(3, 3, 2, dtype=torch.int32)
    else:
        img = torch.zeros(2, 10, 24)[..., ::2]
    with pytest.raises((TypeError, ValueError)):
        kg.gather_tiles(img, anc, 4, 4)


def test_cpu_tensor_takes_plain_version_without_launch():
    before = kg.GATHER.launches
    kg.gather_tiles(torch.zeros(1, 10, 12), torch.zeros(1, 3, 2, dtype=torch.int32), 4, 4)
    assert kg.GATHER.launches == before
