"""Parity of the port's tile gather (kernel K1) with the JAX package.

On the CPU the port's ``extract_tiles`` runs K1's plain PyTorch version; it is
held against JAX ``extract_tiles`` (its XLA branch, the oracle of the Pallas
kernel) and against the Pallas kernel itself in interpret mode, at the cases
of ``tests/test_pallas_kernels.py``. The output is a copy of image values, so
the tolerance is exact equality.
"""

import importlib.util
from pathlib import Path

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


@pytest.mark.parametrize("bad", ["dtype_img", "dtype_anchor", "shape", "lead", "strided",
                                 "huge_output"])
def test_wrapper_rejects_bad_inputs(bad):
    img = torch.zeros(2, 10, 12)
    anc = torch.zeros(2, 3, 2, dtype=torch.int32)
    size = 4
    if bad == "huge_output":  # six tiles of 2^15 x 2^15: over 2^31 outputs
        size = 2**15
    elif bad == "dtype_img":
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
        kg.gather_tiles(img, anc, size, size)


def test_cpu_tensor_takes_plain_version_without_launch():
    before = kg.GATHER.launches
    kg.gather_tiles(torch.zeros(1, 10, 12), torch.zeros(1, 3, 2, dtype=torch.int32), 4, 4)
    assert kg.GATHER.launches == before


def brute_force_bytes(anchors, h, w, th, tw):
    """``gather_bytes`` by a Python set of (image, row, column) reads."""
    pixels = set()
    batch, n = anchors.shape[:2]
    for b in range(batch):
        for f in range(n):
            ax = min(max(int(anchors[b, f, 0]), -tw), w - 1)
            ay = min(max(int(anchors[b, f, 1]), -th), h - 1)
            for i in range(th):
                for j in range(tw):
                    pixels.add((b, min(max(ay + i, 0), h - 1), min(max(ax + j, 0), w - 1)))
    return 4 * (len(pixels) + anchors.size + batch * n * th * tw)


@pytest.mark.parametrize("kind", ["inside", "negative", "far", "extreme", "overlapping"])
@pytest.mark.parametrize("th,tw", [(11, 34), (22, 22), (3, 5), (1, 1)])
def test_gather_bytes_counts_distinct_pixels(kind, th, tw):
    """The bytes K1 must move (the bound of ``chip_smoke.py``): distinct
    image pixels read, anchors, tiles written. Against a brute-force set
    count, with negative, far out-of-range and int32-extreme anchors."""
    rng = np.random.default_rng(len(kind) * 100 + th * tw)
    batch, n, h, w = 2, 9, 30, 47
    lo, hi = {"inside": ((0, 0), (w, h)), "negative": ((-40, -25), (5, 5)),
              "far": ((-500, -400), (600, 500)), "extreme": ((0, 0), (w, h)),
              "overlapping": ((10, 10), (14, 13))}[kind]
    anchors = np.stack([rng.integers(lo[0], hi[0], (batch, n)),
                        rng.integers(lo[1], hi[1], (batch, n))], -1)
    if kind == "extreme":
        anchors[:, :4] = [[-2**31, -2**31], [2**31 - 1, 2**31 - 1],
                          [-2**31, 2**31 - 1], [2**31 - 1, -2**31]]
    anchors = anchors.astype(np.int32)
    got = kg.gather_bytes(torch.from_numpy(anchors), h, w, th, tw)
    assert got == brute_force_bytes(anchors, h, w, th, tw)


def test_gather_bytes_takes_leading_dims():
    anchors = torch.from_numpy(RNG.integers(-5, 40, (2, 3, 6, 2)).astype(np.int32))
    flat = anchors.reshape(6, 6, 2)
    assert kg.gather_bytes(anchors, 20, 30, 4, 7) == brute_force_bytes(flat.numpy(), 20, 30, 4, 7)


def load_module(name):
    """A module of the repository by path, so that nothing depends on which
    directories pytest put on ``sys.path``."""
    path = Path(__file__).resolve().parents[1] / name
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_stereo_chunk_gathers_at_the_checked_shapes(monkeypatch):
    """A staged stereo run on the CPU (192x320, 4 frames, one chunk of 3
    steps) makes 16 tile gathers through ``ops/image.py``, and their shapes
    are exactly the ones that ``chip_smoke.py`` times and the card tests
    check, so a new shape on the path cannot escape either."""
    from uasl_motion_estimation_tpu_torch.models import pipeline as tp
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu_torch.utils import synthetic

    calls = []
    real = tim.gather_tiles

    def record(img, anchors, th, tw):
        calls.append((th, tw))
        return real(img, anchors, th, tw)

    monkeypatch.setattr(tim, "gather_tiles", record)
    rig = synthetic.CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                              height=192, width=320)
    seq = synthetic.SyntheticStereoSequence(n_frames=4, rig=rig, seed=0)
    cfg = tp.default_config(Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline)
    pipe = tp.OdometryPipeline(cfg, seed=0, device="cpu")
    ls, rs = pipe.stage_frames([seq.frame(i) for i in range(4)])
    traj = pipe.run_staged(ls, rs, chunk=3)
    assert traj.shape == (4, 4, 4)
    smoke = load_module("chip_smoke.py")
    card_tests = load_module("tests/test_torch_cuda.py")
    assert len(calls) == smoke.K1_PER_CHUNK == 16
    assert set(calls) == set(smoke.SHAPES) == set(card_tests.MAIN_PATH_TILES)
