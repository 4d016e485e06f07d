"""Exact Hamming matching: top-2 Lowe ratio + cross-check + strongest
``max_matches`` (torch twin of ``meatmodeler_tpu/ops/matching.py``).

Plain PyTorch: the reference's distance matrix is an XLA matmul, not a
Pallas kernel. Bits are {0, 1}, so |a| + |b| - 2 a.b in float32 is exact
(sums <= 256) with TF32 off. Batched over leading pair dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Matches", "hamming_matrix", "match_descriptors"]

_BIG = 1e9
# Pairs matched at once hold at most this many (Q, T) distances: the eager
# distance matrix and its temporaries take ~5 x 4 bytes an entry, and all
# pairs at once at the default 20000 features (1.6 GB a pair) outgrow an
# 80 GB card from ~12 keyframe pairs on.
_BLOCK_ENTRIES = 1 << 30


class Matches(NamedTuple):
    query_idx: torch.Tensor  # (..., M) int64 index into the query set
    train_idx: torch.Tensor  # (..., M) int64 index into the train set
    distance: torch.Tensor  # (..., M) float32 best Hamming distance
    mask: torch.Tensor  # (..., M) bool validity


def hamming_matrix(query: torch.Tensor, train: torch.Tensor) -> torch.Tensor:
    """(..., Q, T) Hamming distances between {0, 1} bit descriptors."""
    q = query.to(torch.float32)
    t = train.to(torch.float32)
    dot = q @ t.transpose(-1, -2)
    return q.sum(-1)[..., :, None] + t.sum(-1)[..., None, :] - 2.0 * dot


def match_descriptors(
    query: torch.Tensor,
    train: torch.Tensor,
    query_mask: torch.Tensor,
    train_mask: torch.Tensor,
    ratio: float = 0.75,
    max_distance: float = 256.0,
    max_matches: int = 4096,
    cross_check: bool = True,
) -> Matches:
    """knnMatch(k=2) + Lowe ratio + optional mutual-nearest check; matches
    come out best-distance-first (ties toward the lower query index, as
    ``lax.top_k`` orders them). A leading pair axis is matched in blocks of
    at most ``_BLOCK_ENTRIES`` distances (each pair on its own, so the
    result is the same)."""
    pairs = query.shape[0] if query.ndim == 3 else 1
    per = max(1, _BLOCK_ENTRIES // max(1, query.shape[-2] * train.shape[-2]))
    if per < pairs:
        parts = [
            match_descriptors(query[i:i + per], train[i:i + per], query_mask[i:i + per], train_mask[i:i + per],
                              ratio, max_distance, max_matches, cross_check)
            for i in range(0, pairs, per)
        ]
        return Matches(*(torch.cat(x) for x in zip(*parts)))
    big = torch.tensor(_BIG, dtype=torch.float32, device=query.device)
    d = hamming_matrix(query, train)
    d = torch.where(train_mask[..., None, :], d, big)
    d = torch.where(query_mask[..., :, None], d, big)

    best_t = torch.argmin(d, dim=-1)  # first minimum, like jnp.argmin
    best_d = torch.gather(d, -1, best_t[..., None])[..., 0]
    iota_t = torch.arange(d.shape[-1], device=d.device)
    second_d = torch.amin(torch.where(iota_t == best_t[..., None], big, d), dim=-1)

    good = best_d < ratio * second_d
    good &= best_d <= max_distance
    good &= query_mask
    if cross_check:
        best_q_for_t = torch.argmin(d, dim=-2)  # (..., T)
        rows = torch.arange(d.shape[-2], device=d.device)
        good &= torch.gather(best_q_for_t, -1, best_t) == rows

    scores = torch.where(good, -best_d, -big)
    k = min(max_matches, scores.shape[-1])
    top_scores, qidx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_scores, qidx = top_scores[..., :k], qidx[..., :k]
    keep = top_scores > -big
    return Matches(
        query_idx=qidx,
        train_idx=torch.gather(best_t, -1, qidx),
        distance=torch.where(keep, -top_scores, torch.full_like(top_scores, torch.inf)),
        mask=keep,
    )
