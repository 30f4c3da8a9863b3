"""Dense vectorized FAST-16 corner detection.

Data-parallel reformulation of the reference's per-cell scalar FAST
(ORBextractor::ComputeKeyPointsOctTree, src/ORBextractor.cc:763-878):
instead of looping over 35x35 cells, we evaluate the segment test at every
pixel with 16 shifted copies of the image (elementwise work), compute the
arc-min score (the max threshold at which the pixel stays a corner), apply
3x3 NMS, and let the grid top-K stage (extractor.py) do spatial balancing.

The high/low threshold fallback (20 -> 7, ORBextractor.cc:835-860) becomes
score arithmetic: scores are computed once at the *low* threshold, and
corners that also pass the high threshold get a rank bonus so weak corners
are only selected in cells with no strong ones.
"""

from __future__ import annotations

import jax.numpy as jnp

# Bresenham circle of radius 3 — the 16 (dx, dy) offsets in contiguous order.
_CIRCLE = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)
ARC_LEN = 9  # contiguous arc length for FAST-9/16


def _shift2d(img: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Shift so out[y, x] = img[y + dy, x + dx], zero-padded."""
    h, w = img.shape
    py = (max(0, -dy), max(0, dy))
    px = (max(0, -dx), max(0, dx))
    p = jnp.pad(img, (py, px))
    return p[py[0] + dy: py[0] + dy + h, px[0] + dx: px[0] + dx + w]


def fast_score(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Per-pixel FAST-9/16 corner score.

    score[y, x] = max over the 16 length-9 arcs of
                  min over the arc of (I_circle - I_center)   [bright arcs]
              or  min over the arc of (I_center - I_circle)   [dark arcs]
    which equals the largest threshold at which the pixel passes the segment
    test; 0 where the test fails at `threshold`. Border pixels (3 px) are 0.
    """
    center = img
    diffs = jnp.stack(
        [_shift2d(img, dy, dx) - center for (dx, dy) in _CIRCLE], axis=0)
    # wrap-around windows: append the first ARC_LEN-1 entries
    circ_b = jnp.concatenate([diffs, diffs[:ARC_LEN - 1]], axis=0)
    circ_d = -circ_b
    # min over each length-9 window, for all 16 window starts
    min_b = circ_b[:16]
    min_d = circ_d[:16]
    for i in range(1, ARC_LEN):
        min_b = jnp.minimum(min_b, circ_b[i:i + 16])
        min_d = jnp.minimum(min_d, circ_d[i:i + 16])
    v_bright = jnp.max(min_b, axis=0)
    v_dark = jnp.max(min_d, axis=0)
    score = jnp.maximum(v_bright, v_dark)
    score = jnp.where(score > threshold, score, 0.0)
    # zero out the 3-px border where shifts wrapped garbage in
    h, w = img.shape
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    border = (ys < 3) | (ys >= h - 3) | (xs < 3) | (xs >= w - 3)
    return jnp.where(border, 0.0, score)


def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """Keep only local maxima in a 3x3 neighborhood. Ties are broken
    lexicographically (a pixel must be strictly greater than its earlier
    neighbors and >= its later neighbors), so plateaus yield one peak."""
    earlier_max = None
    later_max = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n = _shift2d(score, dy, dx)
            if (dy, dx) < (0, 0):
                earlier_max = n if earlier_max is None else jnp.maximum(earlier_max, n)
            else:
                later_max = n if later_max is None else jnp.maximum(later_max, n)
    keep = (score > earlier_max) & (score >= later_max)
    return jnp.where(keep, score, 0.0)
