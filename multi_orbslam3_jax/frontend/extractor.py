"""Full ORB extraction: pyramid -> FAST -> spatially-balanced top-K ->
orientation -> BRIEF, producing a fixed-size FrameFeatures batch.

Fixed-shape redesign of ORBextractor::operator() (src/ORBextractor.cc:1068-1178):
- the quadtree DistributeOctTree (:537-761) becomes per-cell top-K followed
  by per-level top-N — same goal (spatial balance with score priority),
  static shapes, no recursion;
- the 20 -> 7 threshold fallback (:835-860) becomes a rank bonus for strong
  corners (see fast.py);
- per-level feature budgets follow the reference's geometric distribution
  (nfeatures * (1-q)/(1-q^L) * q^lv, q = 1/scale_factor).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from multi_orbslam3_jax.frontend import fast, orb, pyramid
from multi_orbslam3_jax.geometry import camera as cam

EDGE_MARGIN = 19  # reference EDGE_THRESHOLD: keep patches inside the image


class FrameFeatures(NamedTuple):
    """Fixed-capacity per-frame feature batch (the reference's
    Frame::mvKeysUn + mDescriptors, src/Frame.cc)."""

    uv: jnp.ndarray        # (N, 2) raw pixel coords at level-0 scale
    uv_und: jnp.ndarray    # (N, 2) undistorted pixel coords
    response: jnp.ndarray  # (N,) FAST score
    level: jnp.ndarray     # (N,) int32 pyramid level
    angle: jnp.ndarray     # (N,) orientation (radians)
    desc: jnp.ndarray      # (N, 8) uint32 packed BRIEF-256
    valid: jnp.ndarray     # (N,) bool — padding mask

    @property
    def n(self) -> int:
        return self.uv.shape[0]


def level_feature_counts(n_features: int, n_levels: int,
                         scale_factor: float) -> Tuple[int, ...]:
    """Geometric per-level budget (reference ORBextractor.cc:427-439)."""
    q = 1.0 / scale_factor
    total = (1.0 - q ** n_levels) / (1.0 - q)
    counts = []
    acc = 0
    for lv in range(n_levels - 1):
        c = int(round(n_features * q ** lv / total))
        counts.append(c)
        acc += c
    counts.append(max(0, n_features - acc))
    return tuple(counts)


def _pad_to_multiple(x: jnp.ndarray, m: int) -> jnp.ndarray:
    h, w = x.shape
    ph = (-h) % m
    pw = (-w) % m
    return jnp.pad(x, ((0, ph), (0, pw)))


def _select_level_keypoints(score: jnp.ndarray, n_out: int, cell: int,
                            k_cell: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-cell top-k then global top-n over a score map.

    Returns (uv (n_out, 2) float32 at this level's scale, score (n_out,)).
    Empty slots have score 0.
    """
    h, w = score.shape
    padded = _pad_to_multiple(score, cell)
    hp, wp = padded.shape
    ncy, ncx = hp // cell, wp // cell
    cells = padded.reshape(ncy, cell, ncx, cell).transpose(0, 2, 1, 3)
    cells = cells.reshape(ncy * ncx, cell * cell)
    cv, ci = jax.lax.top_k(cells, k_cell)                 # (C, k)
    cy = (jnp.arange(ncy * ncx, dtype=jnp.int32) // ncx)[:, None]
    cx = (jnp.arange(ncy * ncx, dtype=jnp.int32) % ncx)[:, None]
    py = cy * cell + ci // cell
    px = cx * cell + ci % cell
    flat_v = cv.reshape(-1)
    flat_y = py.reshape(-1)
    flat_x = px.reshape(-1)
    if flat_v.shape[0] < n_out:
        # small pyramid levels can have fewer candidate slots than the
        # level budget; pad with score-0 entries so every level emits
        # EXACTLY n_out rows (a short return desyncs the per-level
        # concat lengths downstream — observed as a (1143,) vs (1024,)
        # add_keyframe crash on 320x240 inputs)
        pad = n_out - flat_v.shape[0]
        flat_v = jnp.pad(flat_v, (0, pad))
        flat_y = jnp.pad(flat_y, (0, pad))
        flat_x = jnp.pad(flat_x, (0, pad))
    top_v, top_i = jax.lax.top_k(flat_v, n_out)
    uv = jnp.stack([flat_x[top_i].astype(jnp.float32),
                    flat_y[top_i].astype(jnp.float32)], axis=-1)
    return uv, top_v


@functools.partial(
    jax.jit,
    static_argnames=("height", "width", "n_features", "n_levels",
                     "scale_factor", "cell_size", "fast_hi", "fast_lo",
                     "model"))
def _extract_impl(img: jnp.ndarray, fx, fy, cx_, cy_, dist,
                  *, height: int, width: int, n_features: int,
                  n_levels: int, scale_factor: float, cell_size: int,
                  fast_hi: float = 20.0, fast_lo: float = 7.0,
                  model: str = "pinhole") -> FrameFeatures:
    # uint8 input is the wire format (a quarter of the host->device
    # bytes of float32 frames); all compute is float32 from here
    img = img.astype(jnp.float32)
    counts = level_feature_counts(n_features, n_levels, scale_factor)
    levels = pyramid.build_pyramid(img, n_levels, scale_factor)

    uvs, resps, lvls, angs, descs, valids = [], [], [], [], [], []
    strong_bonus = 1e6
    for lv, im in enumerate(levels):
        n_lv = counts[lv]
        if n_lv == 0:
            continue
        s = fast.nms3x3(fast.fast_score(im, fast_lo))
        h, w = im.shape
        ys = jnp.arange(h)[:, None]
        xs = jnp.arange(w)[None, :]
        interior = ((ys >= EDGE_MARGIN) & (ys < h - EDGE_MARGIN)
                    & (xs >= EDGE_MARGIN) & (xs < w - EDGE_MARGIN))
        s = jnp.where(interior, s, 0.0)
        eff = s + jnp.where(s >= fast_hi, strong_bonus, 0.0)
        k_cell = 4
        uv_lv, eff_v = _select_level_keypoints(eff, n_lv, cell_size, k_cell)
        valid = eff_v > 0.0
        resp = jnp.where(eff_v >= strong_bonus, eff_v - strong_bonus, eff_v)
        ang = orb.ic_angle(im, uv_lv)
        blur = pyramid.gaussian_blur(im)
        desc = orb.compute_descriptors(blur, uv_lv, ang)
        scale = jnp.float32(scale_factor ** lv)
        uvs.append(uv_lv * scale)
        resps.append(resp)
        lvls.append(jnp.full((n_lv,), lv, jnp.int32))
        angs.append(ang)
        descs.append(desc)
        valids.append(valid)

    uv = jnp.concatenate(uvs)[:n_features]
    response = jnp.concatenate(resps)[:n_features]
    level = jnp.concatenate(lvls)[:n_features]
    angle = jnp.concatenate(angs)[:n_features]
    desc = jnp.concatenate(descs)[:n_features]
    valid = jnp.concatenate(valids)[:n_features]
    # pad (counts may sum < n_features after rounding)
    n_have = uv.shape[0]
    if n_have < n_features:
        padn = n_features - n_have
        uv = jnp.pad(uv, ((0, padn), (0, 0)))
        response = jnp.pad(response, (0, padn))
        level = jnp.pad(level, (0, padn))
        angle = jnp.pad(angle, (0, padn))
        desc = jnp.pad(desc, ((0, padn), (0, 0)))
        valid = jnp.pad(valid, (0, padn))

    K = cam.PinholeK(fx, fy, cx_, cy_)
    if model == "kb8":
        # Kannala-Brandt fisheye (reference KannalaBrandt8.cpp, TUM-VI
        # 512): keypoints are unprojected through the KB8 polynomial and
        # re-projected onto the IDEAL pinhole K — from here the whole
        # pipeline (matching, pose opt, BA) runs on the ideal model. The
        # extreme periphery (ray angle > ~72 deg, where the pinhole
        # rectification degenerates) is dropped via the bearing-z gate.
        bearing = cam.kb8_unproject(K, dist[:4], uv)
        bnorm = bearing / jnp.linalg.norm(bearing, axis=-1, keepdims=True)
        central = bnorm[..., 2] > 0.3
        uv_und = cam.project(K, bearing)
        valid = valid & central
    else:
        uv_und = cam.undistort_pixels(K, uv, dist)
    return FrameFeatures(uv=uv, uv_und=uv_und, response=response, level=level,
                         angle=angle, desc=desc, valid=valid)


def extract_features(img: jnp.ndarray, config) -> FrameFeatures:
    """Extract ORB features from a (H, W) float32 grayscale image in [0, 255].

    `config` is a SystemConfig; shapes/budgets specialize the jit once per
    (resolution, feature budget).
    """
    o = config.orb
    c = config.camera
    dist = jnp.asarray(c.kb + (0.0,), jnp.float32) if c.model == "kb8" \
        else jnp.asarray(c.dist, jnp.float32)
    return _extract_impl(
        img, jnp.float32(c.fx), jnp.float32(c.fy), jnp.float32(c.cx),
        jnp.float32(c.cy), dist,
        height=c.height, width=c.width, n_features=o.n_features,
        n_levels=o.n_levels, scale_factor=o.scale_factor,
        cell_size=o.cell_size, fast_hi=o.fast_threshold,
        fast_lo=o.fast_threshold_min, model=c.model)
