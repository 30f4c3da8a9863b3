#!/usr/bin/env python
"""Train and persist the BoW vocabulary on REAL extracted descriptors.

Replaces the reference's dependency on the pre-trained ORBvoc.txt
(src/ClientSystem.cc:69-77): renders a corpus of synthetic textured
worlds (many seeds, varied trajectories/viewpoints), extracts ORB
descriptors with the actual frontend, trains the hierarchical binary
k-means tree, and saves the artifact next to the bow package so
`default_vocabulary` loads it.

Usage:
    python apps/train_vocabulary.py [--worlds 30] [--frames 6] \
        [--branching 10] [--depth 4] [--out <path>]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=30)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--branching", type=int, default=10)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--max-train", type=int, default=80000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax.numpy as jnp
    import numpy as np

    from multi_orbslam3_jax import config as cfg
    from multi_orbslam3_jax.bow import vocabulary as vocm
    from multi_orbslam3_jax.dataio import synthetic
    from multi_orbslam3_jax.frontend import extractor
    from multi_orbslam3_jax.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    c = cfg.synthetic_mono()
    all_desc = []
    for w in range(args.worlds):
        seq = synthetic.make_sequence(
            c, n_frames=args.frames, n_points=700, seed=100 + w,
            trajectory="circle" if w % 2 else "forward",
            phase=0.2 * (w % 5))
        for i in range(seq.images.shape[0]):
            feats = extractor.extract_features(
                jnp.asarray(seq.images[i], jnp.float32), c)
            valid = np.array(feats.valid)
            all_desc.append(np.array(feats.desc)[valid])
        print(f"world {w}: {sum(d.shape[0] for d in all_desc)} descriptors",
              file=sys.stderr, flush=True)
    descs = np.concatenate(all_desc)
    print(f"training on {descs.shape[0]} descriptors "
          f"(k={args.branching}, L={args.depth})", file=sys.stderr)
    voc = vocm.train_vocabulary(descs, args.branching, args.depth,
                                max_train=args.max_train)
    out = args.out or vocm._bundled_path(args.branching, args.depth)
    vocm.save_vocabulary(voc, out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
