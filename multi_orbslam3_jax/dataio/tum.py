"""TUM-format trajectory IO (reference SaveKeyFrameTrajectoryEuRoC,
src/ServerSystem.cc:134-186 / src/ClientSystem.cc:475-527: one line per
keyframe, "t x y z qx qy qz qw", world-from-camera convention)."""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np

from multi_orbslam3_jax.geometry import so3


def write_tum(path: str, trajectory: Iterable[Tuple[float, np.ndarray]]) -> None:
    """trajectory: iterable of (timestamp, T_cw 4x4). Writes T_wc (inverted)
    like the reference (Twc = Tcw^-1 before saving)."""
    import jax.numpy as jnp
    lines = []
    for ts, T_cw in trajectory:
        R_cw = T_cw[:3, :3]
        t_cw = T_cw[:3, 3]
        R_wc = R_cw.T
        t_wc = -R_wc @ t_cw
        q = np.asarray(so3.to_quaternion(jnp.asarray(R_wc)))  # (w, x, y, z)
        lines.append(f"{ts:.6f} {t_wc[0]:.7f} {t_wc[1]:.7f} {t_wc[2]:.7f} "
                     f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_tum(path: str) -> List[Tuple[float, np.ndarray]]:
    out = []
    import jax.numpy as jnp
    from multi_orbslam3_jax.geometry import so3 as _so3
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            ts, x, y, z, qx, qy, qz, qw = vals[:8]
            R_wc = np.asarray(_so3.from_quaternion(
                jnp.asarray([qw, qx, qy, qz])))
            T_wc = np.eye(4)
            T_wc[:3, :3] = R_wc
            T_wc[:3, 3] = [x, y, z]
            T_cw = np.linalg.inv(T_wc)
            out.append((ts, T_cw.astype(np.float32)))
    return out
