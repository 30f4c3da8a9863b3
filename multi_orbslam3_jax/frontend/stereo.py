"""Stereo feature matching + RGBD depth ingestion.

Replaces the reference Frame's stereo path (ComputeStereoMatches,
src/Frame.cc:785-965: epipolar-row search + SAD subpixel refine) and the
RGBD path (ComputeStereoFromRGBD, :966: depth -> virtual right
coordinate). Here: one masked Hamming matrix between left/right
feature batches with a row-proximity + disparity-range mask; subpixel SAD
refinement is dropped (descriptor matching at our feature density hits
~0.5 px, and depth-seeded landmarks get polished by BA immediately).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from multi_orbslam3_jax.frontend import matcher
from multi_orbslam3_jax.frontend.extractor import FrameFeatures


class StereoDepth(NamedTuple):
    """Per-left-feature stereo measurements (the reference's mvuRight /
    mvDepth arrays)."""
    u_right: jnp.ndarray   # (N,) right-image u coordinate (-1 no match)
    depth: jnp.ndarray     # (N,) metric depth (-1 no match)
    valid: jnp.ndarray     # (N,) bool


@jax.jit
def stereo_match(featsL: FrameFeatures, featsR: FrameFeatures,
                 baseline_fx: jnp.ndarray, row_tol: float = 2.0,
                 max_disparity: float = 128.0,
                 max_dist: int = matcher.TH_HIGH) -> StereoDepth:
    """Match rectified left/right feature batches along epipolar rows.
    baseline_fx = baseline * fx (so depth = baseline_fx / disparity)."""
    dv = jnp.abs(featsL.uv_und[:, None, 1] - featsR.uv_und[None, :, 1])
    disp = featsL.uv_und[:, None, 0] - featsR.uv_und[None, :, 0]
    lv_ok = jnp.abs(featsL.level[:, None] - featsR.level[None, :]) <= 1
    # row tolerance scales with pyramid level (coarser levels are blurrier)
    tol = row_tol * jnp.power(1.2, featsL.level.astype(jnp.float32))
    mask = (dv <= tol[:, None]) & (disp > 0.3) & (disp < max_disparity) \
        & lv_ok & featsL.valid[:, None] & featsR.valid[None, :]
    dist = jnp.where(mask, matcher.hamming_matrix(featsL.desc, featsR.desc),
                     matcher.BIG)
    idx, best, second = matcher._best_two(dist)
    ok = (best <= max_dist) & ((best <= 0.9 * second) |
                               (second >= matcher.BIG))
    u_r = featsR.uv_und[jnp.where(ok, idx, 0), 0]
    d = disp[jnp.arange(disp.shape[0]), jnp.where(ok, idx, 0)]
    depth = baseline_fx / jnp.maximum(d, 1e-6)
    return StereoDepth(u_right=jnp.where(ok, u_r, -1.0),
                       depth=jnp.where(ok, depth, -1.0), valid=ok)


@jax.jit
def rgbd_depth(feats: FrameFeatures, depth_img: jnp.ndarray,
               baseline_fx: jnp.ndarray) -> StereoDepth:
    """Depth-image lookup at keypoint positions (virtual right coordinate
    u_r = u - baseline_fx / depth, reference ComputeStereoFromRGBD)."""
    h, w = depth_img.shape
    x = jnp.clip(jnp.round(feats.uv[:, 0]).astype(jnp.int32), 0, w - 1)
    y = jnp.clip(jnp.round(feats.uv[:, 1]).astype(jnp.int32), 0, h - 1)
    d = depth_img[y, x]
    ok = feats.valid & (d > 0.05)
    u_r = feats.uv_und[:, 0] - baseline_fx / jnp.maximum(d, 1e-6)
    return StereoDepth(u_right=jnp.where(ok, u_r, -1.0),
                       depth=jnp.where(ok, d, -1.0), valid=ok)
