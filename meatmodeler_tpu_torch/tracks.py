"""SoA track store (torch twin of ``meatmodeler_tpu/tracks.py``).

Fixed-capacity tensors ``coords[T, F, 2]``, ``obs_mask[T, F]``, ``alive``,
``used``, ``last_feature_idx``, ``points`` and ``octaves``; association is
by keypoint index. ``update_tracks_scan`` is the reference's ``lax.scan``
written as a Python loop over consecutive keyframe pairs; every step is the
reference's ``update_tracks``, including its write order (where two match
rows claim one feature, the later row wins, as XLA's CPU scatter leaves it).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = [
    "TrackStore",
    "make_store",
    "update_tracks",
    "update_tracks_scan",
    "finalize_tracks",
    "triangulation_endpoints",
]


class TrackStore(NamedTuple):
    coords: torch.Tensor  # (T, F, 2) float32 pixel coords per keyframe
    obs_mask: torch.Tensor  # (T, F) bool
    alive: torch.Tensor  # (T,) bool — still being extended
    used: torch.Tensor  # (T,) bool — slot allocated at some point
    last_feature_idx: torch.Tensor  # (T,) int64 — keypoint index in the latest keyframe
    points: torch.Tensor  # (T, 3) float32 triangulated points (filled later)
    octaves: torch.Tensor  # (T, F) int32 pyramid octave of each observation

    @property
    def capacity(self):
        return self.coords.shape[0]

    @property
    def max_keyframes(self):
        return self.coords.shape[1]


def make_store(max_tracks: int, max_keyframes: int, device=None) -> TrackStore:
    return TrackStore(
        coords=torch.zeros((max_tracks, max_keyframes, 2), dtype=torch.float32, device=device),
        obs_mask=torch.zeros((max_tracks, max_keyframes), dtype=torch.bool, device=device),
        alive=torch.zeros(max_tracks, dtype=torch.bool, device=device),
        used=torch.zeros(max_tracks, dtype=torch.bool, device=device),
        last_feature_idx=torch.full((max_tracks,), -1, dtype=torch.int64, device=device),
        points=torch.zeros((max_tracks, 3), dtype=torch.float32, device=device),
        octaves=torch.zeros((max_tracks, max_keyframes), dtype=torch.int32, device=device),
    )


def update_tracks(
    store: TrackStore,
    prev_kf_id: int,
    kf_id: int,
    match_query: torch.Tensor,  # (M,) feature idx in previous keyframe
    match_train: torch.Tensor,  # (M,) feature idx in current keyframe
    match_mask: torch.Tensor,  # (M,) bool
    prev_xy: torch.Tensor,  # (K, 2)
    curr_xy: torch.Tensor,  # (K, 2)
    prev_octave: Optional[torch.Tensor] = None,  # (K,) int32
    curr_octave: Optional[torch.Tensor] = None,
) -> TrackStore:
    """One keyframe step of the reference's ``pointTracking``: extend live
    tracks whose last feature matched, pop the rest, and start
    2-observation tracks from the leftover matches in the lowest free slots."""
    device = store.coords.device
    t_cap = store.capacity
    n_feats, n_curr = prev_xy.shape[0], curr_xy.shape[0]
    m_cap = match_query.shape[0]
    if prev_octave is None:
        prev_octave = torch.zeros(n_feats, dtype=torch.int32, device=device)
    if curr_octave is None:
        curr_octave = torch.zeros(n_curr, dtype=torch.int32, device=device)
    match_query = match_query.long()
    match_train = match_train.long()
    rows = torch.arange(m_cap, device=device)

    # previous-keyframe feature -> match row (or -1); the later row wins.
    match_of_feat = torch.full((n_feats,), -1, dtype=torch.int64, device=device)
    match_of_feat.scatter_reduce_(
        0, torch.where(match_mask, match_query, 0), torch.where(match_mask, rows, -1), reduce="amax"
    )

    # --- extend / pop live tracks ---
    live_feat = torch.clamp(store.last_feature_idx, 0, n_feats - 1)
    m_row = torch.where(store.alive, match_of_feat[live_feat], -1)
    extended = store.alive & (m_row >= 0)
    new_train = match_train[torch.clamp(m_row, 0, m_cap - 1)]
    new_train_c = torch.clamp(new_train, 0, n_curr - 1)
    coords = store.coords.clone()
    obs_mask = store.obs_mask.clone()
    octaves = store.octaves.clone()
    coords[:, kf_id] = torch.where(extended[:, None], curr_xy[new_train_c], coords[:, kf_id])
    obs_mask[:, kf_id] |= extended
    octaves[:, kf_id] = torch.where(extended, curr_octave[new_train_c], octaves[:, kf_id])
    alive = extended.clone()
    last_feature_idx = torch.where(extended, new_train, store.last_feature_idx)

    # --- matches consumed by an extension; the rest start new tracks ---
    consumed = torch.zeros(m_cap, dtype=torch.bool, device=device)
    consumed[m_row[extended]] = True
    is_new = match_mask & ~consumed

    # Prefix-sum allocator over free slots in index order.
    free = ~store.used
    slot_key = torch.where(free, torch.arange(t_cap, device=device), t_cap + torch.arange(t_cap, device=device))
    free_slots = torch.argsort(slot_key)
    new_rank = torch.cumsum(is_new.to(torch.int64), 0) - 1
    can_alloc = is_new & (new_rank < free.sum())
    tgt = free_slots[torch.clamp(new_rank, 0, t_cap - 1)][can_alloc]
    q = torch.clamp(match_query, 0, n_feats - 1)[can_alloc]
    t = torch.clamp(match_train, 0, n_curr - 1)[can_alloc]

    coords[tgt, prev_kf_id] = prev_xy[q]
    coords[tgt, kf_id] = curr_xy[t]
    obs_mask[tgt, prev_kf_id] = True
    obs_mask[tgt, kf_id] = True
    alive[tgt] = True
    used = store.used.clone()
    used[tgt] = True
    last_feature_idx[tgt] = match_train[can_alloc]
    octaves[tgt, prev_kf_id] = prev_octave[q]
    octaves[tgt, kf_id] = curr_octave[t]
    return TrackStore(coords, obs_mask, alive, used, last_feature_idx, store.points, octaves)


def update_tracks_scan(
    store: TrackStore,
    query_idx: torch.Tensor,  # (F-1, M)
    train_idx: torch.Tensor,  # (F-1, M)
    match_mask: torch.Tensor,  # (F-1, M)
    xy: torch.Tensor,  # (F, K, 2)
    octave: Optional[torch.Tensor] = None,  # (F, K)
) -> TrackStore:
    """Every consecutive-pair update, in keyframe order."""
    if octave is None:
        octave = torch.zeros(xy.shape[:2], dtype=torch.int32, device=xy.device)
    for k in range(query_idx.shape[0]):
        store = update_tracks(
            store, k, k + 1, query_idx[k], train_idx[k], match_mask[k],
            xy[k], xy[k + 1], octave[k], octave[k + 1],
        )
    return store


def finalize_tracks(store: TrackStore) -> TrackStore:
    """End of video: every live track is popped."""
    return store._replace(alive=torch.zeros_like(store.alive))


def triangulation_endpoints(store: TrackStore):
    """Per-track (first_kf, last_kf, first_xy, last_xy, valid): the
    reference's widest-baseline pair; valid = used with >= 2 observations."""
    f_max = store.max_keyframes
    obs = store.obs_mask.to(torch.int8)
    first_kf = torch.argmax(obs, dim=1)
    last_kf = f_max - 1 - torch.argmax(obs.flip(1), dim=1)
    valid = store.used & (store.obs_mask.sum(1) >= 2)
    rows = torch.arange(store.capacity, device=obs.device)
    return first_kf, last_kf, store.coords[rows, first_kf], store.coords[rows, last_kf], valid
