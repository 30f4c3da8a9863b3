"""Keyframe + landmark culling.

Replaces LocalMapping::KeyFrameCulling (reference src/LocalMapping.cc:1078
— a KF is redundant when >= 90% of its landmarks are seen in >= 3 other
keyframes; in the collaborative topology culling runs on the SERVER, the
client never culls, src/LocalMapping.cc:169,267) and MapPointCulling
(landmarks that never gain enough observations are dropped).

Both are masked reductions over the dense (K, P) observation matrix — no
per-object ref counting.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from multi_orbslam3_jax.map import mapstate as ms
from multi_orbslam3_jax.map.mapstate import MapState


@jax.jit
def redundant_keyframes(m: MapState, protect: jnp.ndarray,
                        redundancy: float = 0.9,
                        min_obs: int = 3) -> jnp.ndarray:
    """(K,) bool mask of cullable keyframes. `protect` marks KFs that must
    stay (current reference, map origins, the newest KF...)."""
    obs = ms.kf_mp_mask(m)                                  # (K, P)
    counts = jnp.sum(obs.astype(jnp.int32), axis=0)         # obs per point
    well_observed = counts >= min_obs
    per_kf_total = jnp.sum(obs, axis=1)
    per_kf_red = jnp.sum(obs & well_observed[None, :], axis=1)
    redundant = (per_kf_total > 0) & \
        (per_kf_red >= redundancy * per_kf_total)
    return redundant & m.kf_valid & ~protect


@jax.jit
def orphan_mappoints(m: MapState, min_obs: int = 2,
                     age_kf: int = 3) -> jnp.ndarray:
    """(P,) bool mask of landmarks that failed to gain observations — older
    than `age_kf` keyframes but observed by fewer than `min_obs` — or whose
    found/visible ratio fell below 0.25 (both tests from the reference's
    MapPointCulling, src/LocalMapping.cc:447-519)."""
    obs = ms.kf_mp_mask(m)
    counts = jnp.sum(obs.astype(jnp.int32), axis=0)
    old_enough = m.mp_ref_kf <= (m.n_kf - age_kf)
    under_observed = old_enough & (counts < min_obs)
    bad_ratio = (m.mp_visible >= 8) & \
        (m.mp_found.astype(jnp.float32) <
         0.25 * m.mp_visible.astype(jnp.float32))
    return m.mp_valid & (under_observed | bad_ratio)


def cull(m: MapState, protect_kf: jnp.ndarray,
         max_kf_per_round: int = 4, age_kf: int = 3) -> Tuple[MapState, int, int]:
    """One culling round: erase orphan landmarks, then up to
    `max_kf_per_round` redundant keyframes (host-driven like the
    reference's incremental culling loop). Returns (map, n_kf, n_mp).

    `age_kf` defaults to the reference's ~3-KF grace period
    (src/LocalMapping.cc:447-519); the collaborative server passes a
    laxer window because its n_kf counter advances in batched ingests."""
    mp_mask = orphan_mappoints(m, age_kf=age_kf)
    n_mp = int(jnp.sum(mp_mask))
    if n_mp > 0:
        slots = jnp.where(mp_mask, jnp.arange(m.max_mp, dtype=jnp.int32), -1)
        m = ms.erase_mappoints(m, slots)
    kf_mask = redundant_keyframes(m, protect_kf)
    kf_ids = jnp.nonzero(kf_mask, size=max_kf_per_round, fill_value=-1)[0]
    n_kf = 0
    for i in range(max_kf_per_round):
        k = int(kf_ids[i])
        if k < 0:
            break
        m = ms.erase_keyframe(m, jnp.int32(k))
        n_kf += 1
    return m, n_kf, n_mp
