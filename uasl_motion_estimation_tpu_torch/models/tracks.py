"""Fixed-capacity feature-track table: the array form of ``WBA_Point``.

Port of ``uasl_motion_estimation_tpu/models/tracks.py``. The reference keeps
a deque of features per track (``WBA_Point<T>``,
include/MotionEstimation/core/feature_types.h:122-197); here a track table is
a (max_tracks, window) structure of tensors with masks:

* ``addMatch`` + ``pop()`` (feature_types.h:136-146) become a roll of the
  window axis and a write at the newest slot;
* births and deaths recycle slots: the valid new detections fill the dead
  slots in order, by a cumulative-sum rank, with no data-dependent shape;
* the (M, W, 4) observation block is the BA problem's observation table
  (solvers/ba.py).

Every function stays on the tensors' device and reads nothing back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TrackTable(NamedTuple):
    uv: torch.Tensor  # (M, W, 4) [ul, vl, ur, vr] per window frame
    obs_mask: torch.Tensor  # (M, W) bool
    active: torch.Tensor  # (M,) bool
    track_id: torch.Tensor  # (M,) int32 unique ids (WBA_Point::m_id)
    pt3d: torch.Tensor  # (M, 3) 3D estimate
    pt3d_valid: torch.Tensor  # (M,) bool
    next_id: torch.Tensor  # () int32
    n_frames: torch.Tensor  # () int32 frames pushed so far

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]

    @property
    def window(self) -> int:
        return self.uv.shape[1]


def empty_table(max_tracks: int, window: int, dtype=torch.float32,
                device: str | torch.device = "cpu") -> TrackTable:
    """A fresh table (capacity and window as TrackingInfo.nb_feats and
    window_size, file_IO.h:69-73)."""
    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return TrackTable(
        uv=zeros(max_tracks, window, 4),
        obs_mask=zeros(max_tracks, window, dt=torch.bool),
        active=zeros(max_tracks, dt=torch.bool),
        track_id=torch.full((max_tracks,), -1, dtype=torch.int32, device=device),
        pt3d=zeros(max_tracks, 3),
        pt3d_valid=zeros(max_tracks, dt=torch.bool),
        next_id=zeros(dt=torch.int32),
        n_frames=zeros(dt=torch.int32),
    )


def _scatter_drop(target: torch.Tensor, values: torch.Tensor, m: int, fill) -> torch.Tensor:
    """``full(m, fill).at[target].set(values, mode="drop")`` with the
    sentinel index ``m`` marking the entries to drop: the scatter writes into
    m + 1 rows and the last one is cut off. Real targets are unique, so the
    result does not depend on the order of the writes."""
    out = torch.full((m + 1, *values.shape[1:]), fill, dtype=values.dtype, device=values.device)
    out[target] = values
    return out[:m]


def advance(table: TrackTable, tracked_uv: torch.Tensor, tracked_ok: torch.Tensor,
            new_uv: torch.Tensor, new_ok: torch.Tensor) -> TrackTable:
    """Push one frame: extend the surviving tracks, recycle dead slots with
    new detections.

    Args:
      tracked_uv: (M, 4) this frame's [ul, vl, ur, vr] for each slot (KLT +
        stereo matching of the slot's previous feature).
      tracked_ok: (M,) tracking/matching success per slot.
      new_uv: (K, 4) fresh detections (K <= M).
      new_ok: (K,) validity of the fresh detections.

    Per slot: active & tracked_ok -> the window rolls (the oldest is popped
    once full, WBA_Point::pop, feature_types.h:142) and the newest slot is
    tracked_uv; active & ~tracked_ok -> the track dies; dead slots take the
    valid new detections in order, each starting a 1-observation window
    with a fresh id. Detections beyond the dead slots are dropped, and the
    ids still advance by the number of valid detections.
    """
    m = table.uv.shape[0]
    dev = table.uv.device
    survives = table.active & tracked_ok

    # obs stay right-aligned: roll left by one, write the newest at the end
    uv_rolled = torch.cat([table.uv[:, 1:], tracked_uv[:, None, :]], dim=1)
    mask_rolled = torch.cat([table.obs_mask[:, 1:],
                             torch.ones_like(table.obs_mask[:, :1])], dim=1)
    uv_after = torch.where(survives[:, None, None], uv_rolled, torch.zeros_like(uv_rolled))
    mask_after = mask_rolled & survives[:, None]

    # detection j fills the dead slot whose rank among dead slots equals its
    # rank among valid detections; m is the "no slot" sentinel
    dead = ~survives
    dead_rank = torch.cumsum(dead.to(torch.int32), dim=0) - 1
    new_rank = torch.cumsum(new_ok.to(torch.int32), dim=0) - 1
    slots = torch.arange(m, dtype=torch.int32, device=dev)
    dead_slot_by_rank = _scatter_drop(torch.where(dead, dead_rank, m).long(), slots, m, m)
    target = torch.where(new_ok, dead_slot_by_rank[torch.clamp(new_rank, 0, m - 1).long()],
                         m).long()

    filled = _scatter_drop(target, new_ok, m, False)
    fill_uv = _scatter_drop(target, new_uv, m, 0.0)
    new_ids = (table.next_id + new_rank).to(torch.int32)
    fill_id = _scatter_drop(target, torch.where(new_ok, new_ids, -1), m, -1)
    n_new = torch.sum(new_ok, dtype=torch.int32)

    fresh_uv = torch.zeros_like(table.uv)
    fresh_uv[:, -1] = fill_uv
    fresh_mask = torch.zeros_like(table.obs_mask)
    fresh_mask[:, -1] = True
    return TrackTable(
        uv=torch.where(filled[:, None, None], fresh_uv, uv_after),
        obs_mask=torch.where(filled[:, None], fresh_mask, mask_after),
        active=survives | filled,
        track_id=torch.where(filled, fill_id,
                             torch.where(survives, table.track_id, -1).to(torch.int32)),
        pt3d=torch.where(filled[:, None], torch.zeros_like(table.pt3d), table.pt3d),
        pt3d_valid=~filled & table.pt3d_valid & survives,
        next_id=(table.next_id + n_new).to(torch.int32),
        n_frames=table.n_frames + 1,
    )


def latest_uv(table: TrackTable) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, 4) newest observation per track and its (M,) validity."""
    return table.uv[:, -1, :], table.active & table.obs_mask[:, -1]


def track_lengths(table: TrackTable) -> torch.Tensor:
    """(M,) observations in the window per track (WBA_Point::getNbFeatures,
    feature_types.h:150)."""
    return torch.sum(table.obs_mask, dim=1)


def ba_window_view(table: TrackTable, min_obs: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """(W, M, 4) observations and (W, M) mask for solvers.ba.BAProblem,
    keeping only active tracks with >= ``min_obs`` observations."""
    keep = (track_lengths(table) >= min_obs) & table.active
    return table.uv.transpose(0, 1), table.obs_mask.transpose(0, 1) & keep[None, :]
