"""Batched ORB descriptor matching.

Data-parallel redesign of the reference ORBmatcher (src/ORBmatcher.cc):
every search strategy becomes a dense (candidates x features) masked
Hamming-distance problem — XOR + population_count on packed uint32 words —
instead of per-cell scalar loops over the feature grid. The reference's
grid acceleration (Frame::GetFeaturesInArea) is replaced by radius masks
applied to the full distance matrix; at N ~ 1024 the dense problem is
small and has no data-dependent shapes.

Thresholds mirror the reference: TH_LOW = 50, TH_HIGH = 100, Lowe ratio,
30-bin rotation-consistency histogram keeping the top 3 bins
(ORBmatcher.cc:44-267 SearchByProjection, :2358 DescriptorDistance).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

TH_LOW = 50
TH_HIGH = 100
HISTO_BINS = 30
BIG = jnp.int32(10_000)


def hamming_matrix(d1: jnp.ndarray, d2: jnp.ndarray) -> jnp.ndarray:
    """(N, 8) x (M, 8) packed uint32 -> (N, M) int32 Hamming distances
    (the reference's hot ORBmatcher::DescriptorDistance,
    src/ORBmatcher.cc:2358). XLA fuses xor+popcount+sum into one pass
    that writes the (N, M) matrix; frontend/reference.py holds the NumPy
    reference it is compared with."""
    x = jnp.bitwise_xor(d1[:, None, :], d2[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


def _best_two(dist: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-row best index, best distance, second-best distance."""
    best_idx = jnp.argmin(dist, axis=1)
    best = jnp.take_along_axis(dist, best_idx[:, None], axis=1)[:, 0]
    masked = dist.at[jnp.arange(dist.shape[0]), best_idx].set(BIG)
    second = jnp.min(masked, axis=1)
    return best_idx, best, second


def rotation_consistency(angle_diff: jnp.ndarray, valid: jnp.ndarray,
                         keep_bins: int = 3) -> jnp.ndarray:
    """Keep only matches whose angle difference falls in the `keep_bins`
    most popular of 30 histogram bins (reference ComputeThreeMaxima)."""
    frac = (angle_diff / (2.0 * jnp.pi)) % 1.0
    bins = jnp.clip((frac * HISTO_BINS).astype(jnp.int32), 0, HISTO_BINS - 1)
    hist = jnp.zeros(HISTO_BINS, jnp.int32).at[bins].add(valid.astype(jnp.int32))
    _, top = jax.lax.top_k(hist, keep_bins)
    in_top = jnp.any(bins[:, None] == top[None, :], axis=1)
    return valid & in_top


class MatchResult(NamedTuple):
    idx: jnp.ndarray    # (N,) int32 index into the second set, -1 if unmatched
    dist: jnp.ndarray   # (N,) int32 Hamming distance (BIG if unmatched)

    @property
    def valid(self) -> jnp.ndarray:
        return self.idx >= 0

    @property
    def count(self) -> jnp.ndarray:
        return jnp.sum(self.idx >= 0)


def match_mutual(desc1: jnp.ndarray, valid1: jnp.ndarray,
                 desc2: jnp.ndarray, valid2: jnp.ndarray,
                 max_dist: int = TH_LOW, ratio: float = 0.9,
                 angle1: jnp.ndarray | None = None,
                 angle2: jnp.ndarray | None = None) -> MatchResult:
    """Mutual nearest-neighbor matching with Lowe ratio + optional rotation
    consistency (the reference's SearchForInitialization pattern,
    ORBmatcher.cc:702)."""
    dist = hamming_matrix(desc1, desc2)
    dist = jnp.where(valid1[:, None] & valid2[None, :], dist, BIG)
    idx12, best12, second12 = _best_two(dist)
    idx21 = jnp.argmin(dist, axis=0)
    mutual = idx21[idx12] == jnp.arange(dist.shape[0])
    ok = (best12 <= max_dist) & (best12 <= ratio * second12) & mutual
    if angle1 is not None and angle2 is not None:
        ok = rotation_consistency(angle1 - angle2[idx12], ok)
    return MatchResult(jnp.where(ok, idx12, -1),
                       jnp.where(ok, best12, BIG))


def match_by_projection(proj_uv: jnp.ndarray, proj_valid: jnp.ndarray,
                        mp_desc: jnp.ndarray,
                        feat_uv: jnp.ndarray, feat_valid: jnp.ndarray,
                        feat_desc: jnp.ndarray, feat_level: jnp.ndarray,
                        radius: jnp.ndarray, pred_level: jnp.ndarray,
                        max_dist: int = TH_HIGH, ratio: float = 0.9,
                        level_slack: int = 1) -> MatchResult:
    """Guided search: for each projected map point (rows), find the best
    feature (cols) within `radius` pixels and a predicted-octave window
    (reference SearchByProjection, ORBmatcher.cc:44-267).

    proj_uv: (M, 2) projected pixel positions, radius: (M,) or scalar,
    pred_level: (M,) predicted octave. Returns per-map-point feature index.
    """
    d2 = jnp.sum((proj_uv[:, None, :] - feat_uv[None, :, :]) ** 2, axis=-1)
    r = jnp.broadcast_to(jnp.asarray(radius, jnp.float32), (proj_uv.shape[0],))
    in_radius = d2 <= (r[:, None] ** 2)
    lv_ok = (jnp.abs(feat_level[None, :] - pred_level[:, None]) <= level_slack)
    mask = (in_radius & lv_ok & proj_valid[:, None] & feat_valid[None, :])
    dist = jnp.where(mask, hamming_matrix(mp_desc, feat_desc), BIG)
    idx, best, second = _best_two(dist)
    ok = (best <= max_dist) & ((best <= ratio * second) | (second >= BIG))
    return MatchResult(jnp.where(ok, idx, -1), jnp.where(ok, best, BIG))


def resolve_duplicate_targets(res: MatchResult, n_targets: int) -> MatchResult:
    """Enforce one-to-one assignment: if several rows matched the same target
    feature, keep only the row with the smallest distance (the reference
    enforces this through MapPoint slot bookkeeping)."""
    tgt = jnp.where(res.idx >= 0, res.idx, n_targets)  # park invalid at n
    best_per_tgt = jnp.full((n_targets + 1,), BIG, jnp.int32).at[tgt].min(res.dist)
    keep = (res.idx >= 0) & (res.dist <= best_per_tgt[tgt])
    # among ties (same dist), keep the first row
    first_row = jnp.full((n_targets + 1,), jnp.int32(res.idx.shape[0]))
    rows = jnp.arange(res.idx.shape[0], dtype=jnp.int32)
    first_row = first_row.at[jnp.where(keep, tgt, n_targets)].min(rows)
    keep = keep & (first_row[tgt] == rows)
    return MatchResult(jnp.where(keep, res.idx, -1),
                       jnp.where(keep, res.dist, BIG))
