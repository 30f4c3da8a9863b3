"""Map checkpoint / resume.

The reference has boost-serialization scaffolding for Map/KeyFrame/
MapPoint (Map::PreSave/PostLoad, src/Map.cc:715/777) but no built code
path actually saves or loads a map (SaveMap commented out,
src/ClientHandler.cc:153-167). Here save/load is a first-class feature:
MapState is a NamedTuple of arrays, so a checkpoint is one npz file —
no pointer-graph fixup pass needed.
"""

from __future__ import annotations

import io
from typing import Dict, Optional

import jax.numpy as jnp
import numpy as np

from multi_orbslam3_jax.map.mapstate import MapState


def save_map(path: str, m: MapState, extra: Optional[Dict] = None) -> None:
    arrays = {f"map.{name}": np.asarray(getattr(m, name))
              for name in m._fields}
    if extra:
        for k, v in extra.items():
            arrays[f"extra.{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_map(path: str) -> tuple[MapState, Dict[str, np.ndarray]]:
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    fields = {}
    for name in MapState._fields:
        key = f"map.{name}"
        if key not in data and name == "kf_ur":
            # checkpoints written before stereo right-u storage: mono map
            k, n = data["map.kf_mp"].shape
            fields[name] = jnp.full((k, n), -1.0, jnp.float32)
            continue
        if key not in data and name == "kf_cam":
            # pre-heterogeneous-camera checkpoints: all-default marker
            k = data["map.kf_mp"].shape[0]
            fields[name] = jnp.zeros((k, 4), jnp.float32)
            continue
        if key not in data and name == "mp_redirect":
            # pre-fusion-forwarding checkpoints: no replacements recorded
            p = data["map.mp_pos"].shape[0]
            fields[name] = jnp.full((p,), -1, jnp.int32)
            continue
        fields[name] = jnp.asarray(data[key])
    extra = {k[len("extra."):]: v for k, v in data.items()
             if k.startswith("extra.")}
    return MapState(**fields), extra
