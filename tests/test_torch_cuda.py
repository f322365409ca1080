"""Tests of the port that need a CUDA card (marker ``cuda``); they skip
where there is none, since a CUDA kernel has no CPU mode. This file imports
no jax, so it also runs where jax is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg

MAIN_PATH_TILES = [(11, 138), (11, 34), (11, 11), (14, 18), (12, 12), (14, 14), (22, 22)]


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("th,tw", MAIN_PATH_TILES)
def test_gather_kernel_matches_plain(th, tw):
    """K1 against its plain version on the card: negative, out-of-range and
    int32-extreme anchors, a batch dim. Exact (the output is a copy)."""
    needs_card()
    gen = torch.Generator().manual_seed(th * 1000 + tw)
    img = (torch.rand(3, 376, 1241, generator=gen) * 255).cuda()
    anc = torch.stack([torch.randint(-300, 1600, (3, 500), generator=gen),
                       torch.randint(-60, 440, (3, 500), generator=gen)], -1)
    anc[:, 0] = torch.tensor([-2**31, 2**31 - 1])
    anc = anc.to(torch.int32).cuda()
    before = kg.GATHER.launches
    got = kg.gather_tiles(img, anc, th, tw)
    torch.cuda.synchronize()
    assert kg.GATHER.launches == before + 1
    assert torch.equal(got, kg.gather_tiles_plain(img, anc, th, tw))


@pytest.mark.cuda
def test_staged_pipeline_on_card_matches_cpu():
    """The staged slice on the card against the port's CPU run (plain
    kernel versions) with the same RANSAC samples: equal success flags,
    motions within 1e-3."""
    needs_card()
    from uasl_motion_estimation_tpu_torch._shared import synthetic
    from uasl_motion_estimation_tpu_torch.models import pipeline as tp
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics

    rig = synthetic.CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                              height=192, width=320)
    seq = synthetic.SyntheticStereoSequence(n_frames=6, rig=rig, seed=0)
    frames = [seq.frame(i) for i in range(6)]
    cfg = tp.default_config(Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv),
                            rig.baseline)._replace(max_features=256)
    cpu = tp.OdometryPipeline(cfg, seed=0, device="cpu")

    def sampler(step, valid):
        return cpu._sample(step, valid.cpu()).to(valid.device)

    out = []
    for dev in ("cpu", "cuda"):
        pipe = tp.OdometryPipeline(cfg, seed=0, device=dev, sampler=sampler)
        ls, rs = pipe.stage_frames(frames)
        out.append(tp._vo_scan_packed(ls, rs, 0, sampler, cfg, 3).cpu().numpy())
    np.testing.assert_array_equal(out[0][:, 16], out[1][:, 16])
    np.testing.assert_allclose(out[1][:, :16], out[0][:, :16], atol=1e-3)
