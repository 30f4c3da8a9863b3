"""Fixed-capacity struct-of-arrays map store.

Fixed-shape redesign of the reference's pointer-graph data model (KeyFrame.cc /
MapPoint.cc / Map.cc / Atlas.cc): keyframes and landmarks live in
pre-allocated device arrays addressed by slot index; validity masks replace
SetBadFlag tombstones; the KF->MP association is a dense per-feature index
array from which covisibility and BA observation lists are derived by
masked reductions instead of mutex-guarded std::map walks.
"""

from multi_orbslam3_jax.map.mapstate import MapState, empty_map  # noqa: F401
