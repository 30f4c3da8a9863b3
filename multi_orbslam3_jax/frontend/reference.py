"""Plain NumPy references for the frontend's device kernels.

Written from the definitions, not from the jnp code: the FAST-9/16
segment test scored as the largest threshold at which 9 contiguous
circle pixels are all brighter (or all darker) than the centre, then a
3x3 non-maximum suppression; and the Hamming distance as XOR plus a
per-byte popcount. On integer-valued images every step is exact, so a
device result must equal these bit for bit.
"""

from __future__ import annotations

import numpy as np

from multi_orbslam3_jax.frontend.fast import _CIRCLE, ARC_LEN

_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.int32)


def _shifted(img: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """out[y, x] = img[y + dy, x + dx], zero outside the image."""
    h, w = img.shape
    p = np.pad(img, 4)
    return p[4 + dy:4 + dy + h, 4 + dx:4 + dx + w]


def fast_score_nms(img: np.ndarray, threshold: float) -> np.ndarray:
    """(H, W) image -> FAST score after 3x3 NMS; 0 off-corner and within
    3 px of the border. Ties: a pixel must beat its earlier neighbours
    (raster order) strictly and its later ones or equal them."""
    img = np.asarray(img, np.float32)
    h, w = img.shape
    circle = np.stack([_shifted(img, dy, dx) for dx, dy in _CIRCLE])
    diff = circle - img[None]
    score = np.zeros((h, w), np.float32)
    for start in range(16):
        arc = diff[[(start + k) % 16 for k in range(ARC_LEN)]]
        score = np.maximum(score, arc.min(0))          # all brighter
        score = np.maximum(score, (-arc).min(0))       # all darker
    score[score <= threshold] = 0.0
    score[:3] = score[-3:] = 0.0
    score[:, :3] = score[:, -3:] = 0.0
    keep = np.ones((h, w), bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if (dy, dx) == (0, 0):
                continue
            n = _shifted(score, dy, dx)
            keep &= (score > n) if (dy, dx) < (0, 0) else (score >= n)
    return np.where(keep, score, 0.0).astype(np.float32)


def hamming_matrix(d1: np.ndarray, d2: np.ndarray,
                   rows_per_chunk: int = 1024) -> np.ndarray:
    """(N, 8) x (M, 8) packed uint32 -> (N, M) int32 Hamming distances."""
    d1 = np.ascontiguousarray(d1, np.uint32)
    d2 = np.ascontiguousarray(d2, np.uint32)
    out = np.empty((d1.shape[0], d2.shape[0]), np.int32)
    for r in range(0, d1.shape[0], rows_per_chunk):
        x = d1[r:r + rows_per_chunk, None, :] ^ d2[None, :, :]
        out[r:r + rows_per_chunk] = _POPCOUNT8[x.view(np.uint8)].sum(-1)
    return out
