"""The port on the JAX package's stress regimes (``tests/test_stress.py``,
``benchmarks/stress_worlds.py``), on the CPU at the 192x320 rig.

- The three worlds of ``tests/test_stress.py`` through the port's staged
  engine, at JAX's own gates: pure rotation < 0.08 m, a 5 deg/frame corner
  on the default configuration < 0.15 m, a low-texture stretch < 0.12 m
  (the port reads 0.0384 / 0.1240 / 0.0708 m on the CPU).
- The stress KLT profile of ``stress_worlds.py`` (5 pyramid levels, 14 and 6
  iterations, tile margin 7: a 26x26 tile, which no template instantiation
  of the CUDA gather covers, and a 12x20 top level smaller than the tile, so
  every read there is edge-replicated) against JAX's ``klt_track`` on the
  same pair of the 5 deg/frame corner (22-34 px of flow), with
  ``test_torch_frontend.py::test_klt_track``'s tolerance: valid masks equal
  on >= 98 % of the slots, points within 1e-3 px where both keep a track,
  residuals within 1e-3 relative and 2e-2 absolute.
- The unified engine on turn_10deg with the stress profile, fed JAX's
  RANSAC draws (``tools/jax_draws``, from ``tools/jax_stress_reference.py
  --dump-draws``), reads JAX's ATE of the VO chain and after BA within 5 mm
  at RANSAC seeds 1 (``stress_r05.json``'s) and 4 (JAX's worst of 0-5):
  the port's numerics on the hardest regime, apart from its own draws
  (0.01 mm measured, on the CPU and on the card).
- The stress profile's engines make only K1 calls that ``chip_smoke.py``
  holds against the plain version on the card (``held_cases``), the 26x26
  tile at all 5 levels among them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gather import load_module
from uasl_motion_estimation_tpu.models import frontend as jfe
from uasl_motion_estimation_tpu_torch.models import frontend as tfe
from uasl_motion_estimation_tpu_torch.models.pipeline import OdometryPipeline, default_config
from uasl_motion_estimation_tpu_torch.ops import image as tim
from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
from uasl_motion_estimation_tpu_torch.utils import metrics, synthetic

torch.set_num_threads(1)
RIG = synthetic.CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                          height=192, width=320)
CFG = default_config(Intrinsics(RIG.fu, RIG.fv, RIG.cu, RIG.cv),
                     RIG.baseline)._replace(max_features=256)
SMOKE = load_module("chip_smoke.py")


def run_world(seq, n) -> float:
    """tests/test_stress.py's run: staged, RANSAC seed 0, chunk 6."""
    pipe = OdometryPipeline(CFG, seed=0, device="cpu")
    traj = pipe.run_staged(*pipe.stage_frames([seq.frame(i) for i in range(n)]), chunk=6)
    return float(metrics.ate_rmse(traj[:, :3, 3], seq.gt_positions()))


@pytest.mark.parametrize("kind,gate", [("pure_rotation", 0.08), ("turn_5deg", 0.15),
                                       ("low_texture", 0.12)])
def test_stress_world_meets_jax_gate(kind, gate):
    n = 18
    if kind == "pure_rotation":
        seq = synthetic.SyntheticStereoSequence(
            n_frames=n, rig=RIG, seed=7,
            trajectory=synthetic.stress_trajectory("pure_rotation", n))
    elif kind == "turn_5deg":
        seq = synthetic.SyntheticStereoSequence(
            n_frames=n, rig=RIG, seed=7, hall_half_width=45.0,
            trajectory=synthetic.stress_trajectory("sharp_turn", n, turn_rate_deg=5.0))
    else:
        seq = synthetic.SyntheticStereoSequence(n_frames=n, rig=RIG, seed=7,
                                                low_texture_band=(10.0, 16.0))
    assert run_world(seq, n) < gate


@pytest.fixture(scope="module")
def turn_pair():
    """Frames 16 and 17 of stress_worlds.py's 5 deg/frame corner (mid-turn),
    on the uint8 wire, and grid features of the first."""
    _, frames = SMOKE.stress_world("turn_5deg")
    a, b = (np.clip(frames[i][0], 0, 255).astype(np.uint8).astype(np.float32) for i in (16, 17))
    xy, _, v = tim.detect_features_grid(torch.from_numpy(a), 256, 1e-4)
    return a, b, xy.numpy(), v.numpy()


def test_stress_klt_profile_matches_jax(turn_pair):
    a, b, xy, v = turn_pair
    cfg = SMOKE.stress_configs()[1].klt
    assert (cfg.n_levels, cfg.tile_margin, cfg.iters, cfg.iters_coarse) == (5, 7, 14, 6)
    t = tfe.klt_track(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(xy),
                      torch.from_numpy(v), cfg)
    jcfg = jfe.KLTConfig(**cfg._asdict())
    j = jfe.klt_track(jnp.asarray(a), jnp.asarray(b), jnp.asarray(xy), jnp.asarray(v), jcfg)
    tv, jv = t.valid.numpy(), np.asarray(j.valid)
    assert (tv == jv).mean() >= 0.98
    both = tv & jv
    assert both.sum() > 0.3 * len(both)
    flow = np.linalg.norm(np.asarray(j.pts)[both] - xy[both], axis=1)
    assert 22.0 <= np.median(flow) <= 40.0  # the pyramid's regime, not a small step
    np.testing.assert_allclose(t.pts.numpy()[both], np.asarray(j.pts)[both], atol=1e-3)
    np.testing.assert_allclose(t.residual.numpy()[both], np.asarray(j.residual)[both],
                               rtol=1e-3, atol=2e-2)


def test_stress_profile_gathers_at_held_cases():
    """turn_10deg through the staged and the unified engine with the stress
    profile, as chip_smoke.py runs it: every K1 call (batch, tile, level)
    is a case chip_smoke.py holds against the plain version, and the 26x26
    tile comes at all 5 levels."""
    _, frames = SMOKE.stress_world("turn_10deg")
    stress = SMOKE.stress_configs()[1]
    seen = set()
    real = tim.gather_tiles

    def recording(img, anchors, tile_h, tile_w):
        seen.add((int(np.prod(img.shape[:-2])), tile_h, tile_w, *img.shape[-2:]))
        return real(img, anchors, tile_h, tile_w)

    tim.gather_tiles = recording
    try:
        SMOKE.stress_staged(frames, stress, 0, "cpu")
        SMOKE.stress_unified(frames, stress, 1, "cpu")
    finally:
        tim.gather_tiles = real
    assert seen <= SMOKE.held_cases()
    assert sorted({c[3:] for c in seen if c[1:3] == SMOKE.STRESS_TILE},
                  reverse=True) == SMOKE.STRESS_LEVELS


@pytest.mark.parametrize("seed", [1, 4])
def test_unified_turn10_on_jax_draws_reads_jax_ate(seed):
    row = SMOKE.unified_witness("cpu", (seed,), check=False)[0]
    assert row["ba_converged"] == 8
    assert abs(row["diff_vo_m"]) <= SMOKE.WITNESS_TOL
    assert abs(row["diff_ba_m"]) <= SMOKE.WITNESS_TOL
