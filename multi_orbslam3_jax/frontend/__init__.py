"""ORB front end: pyramid, FAST, orientation, BRIEF-256, Hamming matching.

Data-parallel redesign of the reference's ORBextractor.cc /
ORBmatcher.cc: dense per-pixel kernels over fixed-shape images instead of
scalar loops, grid-bucketed top-K instead of the quadtree, and descriptor
matching as masked XOR+popcount reductions.
"""

from multi_orbslam3_jax.frontend.extractor import extract_features, FrameFeatures  # noqa: F401
from multi_orbslam3_jax.frontend import matcher  # noqa: F401
