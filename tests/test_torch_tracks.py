"""The port's track table (``models/tracks.py``) against the JAX reference:
exact, since it is integer bookkeeping and copies.

A random 12-frame sequence of births, deaths and overflows (more valid
detections than dead slots, which the scatter's sentinel row must drop)
goes through both ``advance``; after every frame each field, ``latest_uv``,
``track_lengths`` and ``ba_window_view`` must be equal, dtypes included.
The lifecycle cases of ``tests/test_tracks.py`` run on the port too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uasl_motion_estimation_tpu.models import tracks as jtr
from uasl_motion_estimation_tpu_torch.models import tracks as ttr

torch.set_num_threads(1)
M, W, K = 24, 5, 20


def equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy().dtype == np.asarray(want).dtype


@pytest.mark.parametrize("seed", [0, 1])
def test_advance_sequence_matches_jax(seed):
    rng = np.random.default_rng(seed)
    jt, tt = jtr.empty_table(M, W), ttr.empty_table(M, W)
    overflowed = 0
    for frame in range(12):
        tracked_uv = rng.normal(size=(M, 4)).astype(np.float32) * 100
        tracked_ok = rng.random(M) < rng.uniform(0.3, 0.95)
        new_uv = rng.normal(size=(K, 4)).astype(np.float32) * 100
        new_ok = rng.random(K) < rng.uniform(0.2, 1.0)
        dead = int((~(tt.active.numpy() & tracked_ok)).sum())
        overflowed += int(new_ok.sum() > dead)
        jt = jtr.advance(jt, *(jnp.asarray(x) for x in (tracked_uv, tracked_ok, new_uv, new_ok)))
        tt = ttr.advance(tt, *(torch.from_numpy(x) for x in (tracked_uv, tracked_ok, new_uv,
                                                              new_ok)))
        for name in jtr.TrackTable._fields:
            equal(getattr(tt, name), getattr(jt, name))
        for a, b in zip(ttr.latest_uv(tt), jtr.latest_uv(jt)):
            equal(a, b)
        np.testing.assert_array_equal(ttr.track_lengths(tt).numpy(),
                                      np.asarray(jtr.track_lengths(jt)))
        for min_obs in (1, 2, 3):
            for a, b in zip(ttr.ba_window_view(tt, min_obs), jtr.ba_window_view(jt, min_obs)):
                equal(a, b)
    assert overflowed >= 3
    assert int(ttr.track_lengths(tt).max()) == W  # some track filled its window


def uv(val):
    return torch.full((4,), float(val))


def new(vals):
    if not vals:
        return torch.zeros(0, 4), torch.zeros(0, dtype=torch.bool)
    return torch.stack([uv(v) for v in vals]), torch.ones(len(vals), dtype=torch.bool)


def test_window_eviction_and_recycling():
    """tests/test_tracks.py's lifecycle on the port: the window keeps the
    last W observations; a dead slot takes the next detection with a fresh
    id; extras beyond the capacity are dropped but still advance the ids."""
    t = ttr.empty_table(2, 3)
    t = ttr.advance(t, torch.zeros(2, 4), torch.zeros(2, dtype=torch.bool), *new([1]))
    for v in (2, 3, 4, 5):
        t = ttr.advance(t, uv(v).expand(2, 4), t.active, *new([]))
    slot = int(torch.argmax(t.active.to(torch.int32)))
    assert int(ttr.track_lengths(t)[slot]) == 3
    assert t.uv[slot, :, 0].tolist() == [3, 4, 5]

    t = ttr.empty_table(2, 3)
    t = ttr.advance(t, torch.zeros(2, 4), torch.zeros(2, dtype=torch.bool), *new([1, 2]))
    ids0 = t.track_id.tolist()
    t = ttr.advance(t, uv(9).expand(2, 4), t.active & torch.tensor([False, True]), *new([7]))
    assert t.track_id.tolist() == [2, ids0[1]]
    assert ttr.track_lengths(t).tolist() == [1, 2]

    t = ttr.empty_table(2, 3)
    t = ttr.advance(t, torch.zeros(2, 4), torch.zeros(2, dtype=torch.bool), *new([1, 2, 3]))
    assert int(t.active.sum()) == 2 and int(t.next_id) == 3
