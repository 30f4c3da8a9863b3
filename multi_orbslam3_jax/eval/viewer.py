"""Headless map visualization.

Replaces the reference's Pangolin GL viewers (ClientViewer/ServerViewer/
MapDrawer/FrameDrawer, SURVEY.md §2.7) with offline matplotlib renders —
a headless server has no display, so visualization is snapshot-to-PNG:
top-down map plots (landmarks, keyframe frusta, covisibility edges,
per-agent coloring) and frame overlays (keypoints + tracked landmark
projections).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from multi_orbslam3_jax.map.mapstate import MapState

_AGENT_COLORS = ["tab:blue", "tab:orange", "tab:green", "tab:red"]


def plot_map(m: MapState, path: str, title: str = "map",
             kf_map: Optional[np.ndarray] = None,
             gt_centers: Optional[np.ndarray] = None) -> None:
    """Top-down (x-z) map snapshot (MapDrawer::DrawMapPoints/DrawKeyFrames
    analog). kf_map optionally colors sub-maps (server view over all
    agents' maps, ServerViewer analog)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    mp_valid = np.asarray(m.mp_valid)
    mp = np.asarray(m.mp_pos)[mp_valid]
    if len(mp):
        ax.scatter(mp[:, 0], mp[:, 2], s=1, c="gray", alpha=0.4,
                   label=f"{len(mp)} landmarks")
    kf_valid = np.asarray(m.kf_valid)
    poses = np.asarray(m.kf_pose)[kf_valid]
    agents = np.asarray(m.kf_agent)[kf_valid]
    if len(poses):
        centers = -np.einsum("nji,nj->ni", poses[:, :3, :3], poses[:, :3, 3])
        for a in np.unique(agents):
            sel = agents == a
            ax.plot(centers[sel, 0], centers[sel, 2], ".-", ms=4, lw=0.8,
                    color=_AGENT_COLORS[int(a) % 4], label=f"agent {a} KFs")
    if gt_centers is not None:
        ax.plot(gt_centers[:, 0], gt_centers[:, 2], "k--", lw=0.8,
                alpha=0.6, label="ground truth")
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_title(title)
    ax.legend(loc="upper right", fontsize=8)
    ax.set_aspect("equal")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def plot_frame(img: np.ndarray, uv: np.ndarray, tracked: np.ndarray,
               path: str) -> None:
    """Keypoint overlay (FrameDrawer analog): green = tracked landmark,
    blue = unmatched keypoint."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    ax.imshow(img, cmap="gray", vmin=0, vmax=255)
    t = np.asarray(tracked, bool)
    ax.scatter(uv[~t, 0], uv[~t, 1], s=6, facecolors="none",
               edgecolors="tab:blue", linewidths=0.6)
    ax.scatter(uv[t, 0], uv[t, 1], s=8, facecolors="none",
               edgecolors="lime", linewidths=0.9)
    ax.set_axis_off()
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
