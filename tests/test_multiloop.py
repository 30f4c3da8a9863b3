"""Loop recall drills (round-3 VERDICT Weak #8 / Next #6).

Architecture note: this framework tracks every frame against the WHOLE
fixed-capacity map (pipeline/tracking.py), so a same-map revisit
usually re-acquires old landmarks continuously and drift never
fragments into a detectable "loop" — the correction the reference gets
from CorrectLoop happens implicitly, frame by frame. The loop-closing
cascade earns its keep in the reference's headline Atlas scenario:
tracking is lost (or a dataset jump occurs), a NEW sub-map starts, and
when the camera re-enters known terrain the place-recognition cascade
must weld the sub-maps back together (reference LoopClosing::MergeLocal
src/LoopClosing.cc:1316, Tracking::CreateMapInAtlas). That is what
these drills assert, end-to-end, with the Sim3-continuity retry
(DetectAndReffineSim3FromLastKF analog) active."""

import numpy as np
import pytest

from multi_orbslam3_jax import config as cfg
from multi_orbslam3_jax.dataio import synthetic
from multi_orbslam3_jax.eval import ate
from multi_orbslam3_jax.pipeline.system import MonoSlam, TrackState


@pytest.mark.slow
def test_atlas_loop_welds_submaps_on_revisit():
    c = cfg.synthetic_mono()
    n_frames = 170
    # 1.25 orbits: frames past ~136 re-traverse the start region
    # phase 1.1: the [0, 1.1) arc has poor landmark visibility for the
    # two-view bootstrap (same reason bench_collab starts agents there)
    seq = synthetic.make_sequence(c, n_frames=n_frames, n_points=1200,
                                  seed=21, trajectory="circle",
                                  phase=1.1, arc=2.5 * np.pi)
    slam = MonoSlam(c, enable_loop_closing=True)
    slam.defer_mapping = False     # deterministic: no adoption races
    jump = 80
    for i in range(n_frames):
        ts = float(seq.timestamps[i])
        if i >= jump:
            # a >4 s timestamp jump mid-orbit forces a fresh sub-map
            # (ChangeDataset analog): the run now carries two maps that
            # only place recognition can weld back together
            ts += 10.0
        slam.process_frame(seq.images[i], ts)
    slam._adopt_pending(force=True)

    assert slam.stats.get("maps_created", 0) >= 1, slam.stats
    assert slam.loop_closer.loops_closed >= 1, (
        "place recognition never welded the sub-maps on revisit; "
        f"stats={slam.stats}")
    # after the weld every keyframe lives in ONE map again
    valid = np.asarray(slam.m.kf_valid)
    map_ids = np.asarray(slam.m.kf_map_id)[valid]
    assert len(np.unique(map_ids)) == 1, np.unique(map_ids)

    # post-weld consistency: the FINAL map holds every keyframe in ONE
    # gauge (the per-frame live log spans the pre/post-weld gauges and
    # cannot be aligned as one rigid set — same protocol note as
    # bench_collab). Match keyframes to GT frames by timestamp,
    # un-doing the injected +10 s jump.
    kf_traj = slam.keyframe_trajectory()
    assert len(kf_traj) >= 15
    fps = 20.0
    frames, poses = [], []
    for ts, T in kf_traj:
        t = ts - 10.0 if ts > 5.0 else ts
        fr = int(round(t * fps))
        if 0 <= fr < n_frames:
            frames.append(fr)
            poses.append(T)
    est = ate.camera_centers(np.stack(poses))
    gt = ate.camera_centers(seq.T_cw[frames])
    span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    rmse = ate.ate_rmse(est, gt)
    assert rmse < 0.12 * max(span, 1.0), (rmse, span)
