"""Full-system accuracy + throughput benchmarks.

The reference validates end-to-end: run sequences, save keyframe
trajectories, compare ATE against ground truth
(src/ServerSystem.cc:134-185, ros/launch/Server_euroc.launch:12). This
module does the same in-process for every BASELINE.json configuration:

- mono           : full MonoSlam w/ loop closing on a synthetic sequence
- stereo         : StereoSlam (metric scale, no-scale Umeyama alignment)
- mono_inertial  : MonoInertialSlam with the EuRoC camera-IMU extrinsics
- collab_2agent  : two CollabClients + CollabServer over a shared world
- gba            : global-BA iterations/s on the final arena

Each run does TWO passes over the sequence: pass 1 warms the XLA
compilation caches (every jitted program the pipeline can hit), pass 2 is
timed with a fresh system — so fps numbers include keyframe insertion,
triangulation, fusion, local BA and loop closing, not just the tracking
kernel.

ATE is evaluated over the frames tracked OK, Sim3-aligned for monocular
configs (free scale) and SE(3)-aligned (with_scale=False) for stereo.
An EuRoC runner activates when a dataset directory exists
(dataio/euroc.py ASL layout).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from multi_orbslam3_jax import config as cfg
from multi_orbslam3_jax.eval import ate

# EuRoC cam0 body-from-camera extrinsics (the dataset's T_BS; the
# reference loads it as Tbc from ros/conf EuRoC yaml — far from identity)
EUROC_T_BC = (
    0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
    0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
    -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
    0.0, 0.0, 0.0, 1.0)


def _euroc_scale_config(**kw) -> cfg.SystemConfig:
    cam = cfg.CameraConfig(width=752, height=480, fx=458.654, fy=457.296,
                           cx=376.0, cy=240.0, **kw)
    return cfg.SystemConfig(camera=cam)


def _setup(walls: List[float]) -> Dict:
    """First pass (compiles + one run) vs the timed second pass; their
    difference is the set-up (compile) time."""
    return {"first_pass_s": round(walls[0], 2),
            "setup_s": round(walls[0] - walls[1], 2)}


def _ate_over_ok(trajectory, states, gt_T_cw, with_scale=True,
                 skip_head: int = 0) -> Optional[Dict]:
    from multi_orbslam3_jax.pipeline.system import TrackState
    ok_idx = [i for i, s in enumerate(states)
              if s == TrackState.OK and i >= skip_head]
    if len(ok_idx) < 10:
        return None
    est = np.stack([trajectory[i][1] for i in ok_idx])
    gt = gt_T_cw[ok_idx]
    e = ate.camera_centers(est)
    g = ate.camera_centers(gt)
    span = float(np.linalg.norm(g.max(0) - g.min(0)))
    return {"ate_rmse": round(ate.ate_rmse(e, g, with_scale), 4),
            "span": round(span, 3), "frames_ok": len(ok_idx)}


def _drive_mono(slam_factory, seq) -> Dict:
    """Two passes: warmup (compilation) + timed run on a fresh system.
    Frames are double-buffered: the next frame's uint8 host->device
    transfer is issued while the current frame computes (a real camera
    pipeline DMAs the same way)."""
    F = seq.images.shape[0]
    frame_ms: List[float] = []
    walls = []
    for timed in (False, True):
        slam = slam_factory()
        frame_ms = []
        nxt = slam.to_device(seq.images[0])
        t0 = time.perf_counter()
        for i in range(F):
            tf = time.perf_counter()
            cur = nxt
            if i + 1 < F:
                nxt = slam.to_device(seq.images[i + 1])
            slam.process_frame_pipelined(cur, float(seq.timestamps[i]))
            frame_ms.append((time.perf_counter() - tf) * 1e3)
        slam.finish()
        walls.append(time.perf_counter() - t0)
    wall = walls[1]
    fm = np.asarray(frame_ms)
    states = [s for _, s in slam.frame_log]
    out = {"fps": round(F / wall, 2), "frames": F, "wall_s": round(wall, 2),
           **_setup(walls),
           "frame_ms_p50": round(float(np.percentile(fm, 50)), 1),
           "frame_ms_p99": round(float(np.percentile(fm, 99)), 1),
           "stats": dict(slam.stats)}
    acc = _ate_over_ok(slam.trajectory, states, seq.T_cw)
    if acc:
        out.update(acc)
    return out


def bench_mono(n_frames: int = 120, seed: int = 5) -> Dict:
    from multi_orbslam3_jax.dataio import synthetic
    from multi_orbslam3_jax.pipeline.system import MonoSlam
    c = _euroc_scale_config()
    seq = synthetic.make_sequence(c, n_frames=n_frames, n_points=1500,
                                  seed=seed, trajectory="forward")
    return _drive_mono(lambda: MonoSlam(c, enable_loop_closing=True), seq)


def bench_stereo(n_frames: int = 80, seed: int = 9) -> Dict:
    from multi_orbslam3_jax.dataio import synthetic
    from multi_orbslam3_jax.pipeline.stereo_system import StereoSlam
    c = _euroc_scale_config(baseline=0.11)   # EuRoC stereo baseline ~11 cm
    seq = synthetic.make_sequence(c, n_frames=n_frames, n_points=1200,
                                  seed=seed, trajectory="forward")
    F = seq.images.shape[0]
    walls = []
    for timed in (False, True):
        slam = StereoSlam(c, enable_loop_closing=True)
        t0 = time.perf_counter()
        for i in range(F):
            slam.process_frame_stereo_pipelined(
                seq.images[i], seq.images_right[i],
                float(seq.timestamps[i]))
        slam.finish()
        walls.append(time.perf_counter() - t0)
    wall = walls[1]
    states = [s for _, s in slam.frame_log]
    out = {"fps": round(F / wall, 2), "frames": F, "wall_s": round(wall, 2),
           **_setup(walls),
           "stats": dict(slam.stats)}
    acc = _ate_over_ok(slam.trajectory, states, seq.T_cw, with_scale=False)
    if acc:
        out.update(acc)
    return out


def bench_mono_inertial(n_frames: int = 90, seed: int = 7) -> Dict:
    from multi_orbslam3_jax.dataio import synthetic
    from multi_orbslam3_jax.pipeline.inertial_system import MonoInertialSlam
    from multi_orbslam3_jax.pipeline.system import TrackState
    c = _euroc_scale_config()
    c = c.replace(imu=cfg.IMUConfig(T_bc=EUROC_T_BC))
    seq = synthetic.make_sequence(c, n_frames=n_frames, n_points=1200,
                                  seed=seed, trajectory="forward", imu=True,
                                  lateral=0.8, sway_freq=0.15)
    F = seq.images.shape[0]
    rate = c.imu.rate_hz
    walls = []
    for timed in (False, True):
        slam = MonoInertialSlam(c, enable_loop_closing=True)
        states = []
        t0 = time.perf_counter()
        for i in range(F):
            dt = np.diff(seq.imu_t[i], prepend=seq.imu_t[i][0] - 1.0 / rate)
            dt = np.where(seq.imu_t[i] > 0, np.maximum(dt, 0.0), 0.0)
            states.append(slam.process_frame_imu(
                seq.images[i], float(seq.timestamps[i]),
                seq.imu_acc[i], seq.imu_gyro[i], dt))
        walls.append(time.perf_counter() - t0)
    wall = walls[1]
    out = {"fps": round(F / wall, 2), "frames": F, "wall_s": round(wall, 2),
           **_setup(walls),
           "frames_ok": sum(1 for s in states if s == TrackState.OK),
           "imu_initialized": bool(slam.imu_initialized),
           "stats": dict(slam.stats)}
    # accuracy protocol: the FINAL map's keyframe trajectory (reference
    # SaveKeyFrameTrajectoryEuRoC — evaluated after the run). The
    # per-frame live log spans every mid-run re-gauge (first VI init,
    # the 4 s VIBA2-analog refinement) and cannot be aligned as one
    # rigid/similar set; keyframe poses all live in the final gauge.
    kf_traj = slam.keyframe_trajectory()
    init_ts = None
    init_f = slam.stats.get("imu_init_frame")
    if init_f is not None and init_f < F:
        init_ts = float(seq.timestamps[init_f]) - float(seq.timestamps[0])
    frames, poses = [], []
    ts0 = float(seq.timestamps[0])
    for t, T in kf_traj:
        if init_ts is not None and t < init_ts:
            continue                    # pre-init segment: visual gauge
        fr = int(round((t - ts0) / (1.0 / c.camera.fps)))
        if 0 <= fr < F:
            frames.append(fr)
            poses.append(T)
    if len(frames) >= 8:
        est = ate.camera_centers(np.stack(poses))
        g = ate.camera_centers(seq.T_cw[frames])
        span = float(np.linalg.norm(g.max(0) - g.min(0)))
        out.update({"ate_rmse": round(ate.ate_rmse(est, g), 4),
                    "span": round(span, 3), "kf_evaluated": len(frames)})
    return out


def bench_collab(n_agents: int = 2, n_frames: int = 150,
                 seed: int = 31, warmup: bool = True) -> Dict:
    """Collaborative benchmark (BASELINE.json configs #4-5): every agent
    orbits the shared world on a circular arc with a phase offset, so the
    run produces BOTH cross-agent merges (overlapping arcs) and loop
    closures (arc self-overlap), with the post-event GBA on by default
    (the reference's LoopClosing.cc:1286-1292 behavior). Reports per-agent
    ATE over the whole OK trajectory AND the post-correction tail."""
    from multi_orbslam3_jax.collab.client import CollabClient
    from multi_orbslam3_jax.collab.server import CollabServer
    from multi_orbslam3_jax.collab.transport import InProcessTransport
    from multi_orbslam3_jax.dataio import synthetic
    from multi_orbslam3_jax.pipeline.system import TrackState
    c = cfg.synthetic_mono()
    # start phases >= 1.1 rad: the orbit's [0, 1.1) arc has poor landmark
    # visibility for INITIALIZATION (standalone sweep: 45/150 frames OK
    # from phase 0.55 vs 148/150 from 1.1+); established maps traverse it
    # fine later in the arc
    # arc > 2*pi: each agent's final ~15% of frames re-traverse its own
    # start region, so same-map loop closures are geometrically possible
    # (the r3 bench's 1.5*pi arc could never self-overlap — loops: 0 was
    # structural, not a recall failure)
    seqs = [synthetic.make_sequence(c, n_frames=n_frames, n_points=1200,
                                    seed=seed, trajectory="circle",
                                    phase=1.1 + 0.55 * a,
                                    arc=2.3 * np.pi)
            for a in range(n_agents)]
    passes = (False, True) if warmup else (True,)
    walls = []
    for timed in passes:
        tr = InProcessTransport()
        clients = [CollabClient(c, a, tr) for a in range(n_agents)]
        server = CollabServer(c, tr, n_agents=n_agents)
        states = [[] for _ in range(n_agents)]
        first_corr = [None] * n_agents
        frame_t = []
        t0 = time.perf_counter()
        for i in range(n_frames):
            ft0 = time.perf_counter()
            for a, cl in enumerate(clients):
                states[a].append(cl.process_frame(
                    seqs[a].images[i], float(seqs[a].timestamps[i])))
                cl.comm_cycle()
                if first_corr[a] is None and \
                        cl.stats["corrections_applied"] > 0:
                    first_corr[a] = i
            server.comm_cycle()
            frame_t.append(time.perf_counter() - ft0)
        server.drain_gba()      # adopt any time-sliced GBA still in flight
        walls.append(time.perf_counter() - t0)
    wall = walls[-1]
    # BOTH throughput definitions under distinct keys (the single-pass
    # tail number excludes first-third jit compiles; the wall number is
    # frames/wall including them — reporting only the tail made collab
    # fps incomparable across rounds and disagree with wall_s):
    total_fps_wall = n_agents * n_frames / wall
    tail = frame_t[len(frame_t) // 3:]
    total_fps_tail = n_agents / max(float(np.mean(tail)), 1e-9)
    total_fps = total_fps_wall if warmup else total_fps_tail
    out = {"agents": n_agents, "frames": n_frames,
           "total_fps": round(total_fps, 2),
           "total_fps_wall": round(total_fps_wall, 2),
           "total_fps_tail": round(total_fps_tail, 2),
           "fps_mode": "two_pass_wall" if warmup else "single_pass_tail",
           "wall_s": round(wall, 2),
           **(_setup(walls) if warmup else {}),
           "merges": server.stats["merges"], "loops": server.stats["loops"],
           "bytes_up_mb": round(tr.bytes_up / 2 ** 20, 1),
           "bytes_down_mb": round(tr.bytes_down / 2 ** 20, 1),
           "server": dict(server.stats)}
    # accuracy metric: the FINAL corrected keyframe trajectory from the
    # server arena per agent (the reference's evaluation — the server's
    # SaveKeyFrameTrajectoryEuRoC, src/ServerSystem.cc:134-185). The
    # per-frame live log spans every mid-run gauge re-base (merge, loops,
    # GBAs) and cannot be aligned as one rigid/similar set.
    ates = []
    # arena timestamps are sequence-relative (client _rel_ts)
    ts_all = np.asarray(seqs[0].timestamps)
    ts_all = ts_all - ts_all[0]
    kf_valid = np.array(server.m.kf_valid)
    kf_agent = np.array(server.m.kf_agent)
    kf_ts = np.array(server.m.kf_timestamp)
    kf_pose = np.array(server.m.kf_pose)
    for a, cl in enumerate(clients):
        sel = np.nonzero(kf_valid & (kf_agent == a))[0]
        acc = None
        if len(sel) >= 8:
            # match GT frames by (relative) timestamp
            fr = np.asarray([int(np.argmin(np.abs(ts_all - t)))
                             for t in kf_ts[sel]])
            est = ate.camera_centers(kf_pose[sel])
            gt = ate.camera_centers(seqs[a].T_cw[fr])
            span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
            acc = {"ate_rmse": round(ate.ate_rmse(est, gt), 4),
                   "span": round(span, 3), "server_kfs": len(sel)}
        if acc is not None:
            n_ok = sum(1 for s in states[a] if s == TrackState.OK)
            acc["frames_ok"] = n_ok
            if first_corr[a] is not None:
                acc["first_corr_frame"] = first_corr[a]
            out[f"agent{a}"] = acc
            ates.append(acc["ate_rmse"])
    if ates:
        out["ate_rmse"] = round(float(np.mean(ates)), 4)
    return out, server


def bench_gba(server=None, iters: int = 40) -> Dict:
    """Global-BA PCG iterations/s on the collaborative arena (the
    BASELINE.json "global BA iters/s" metric, single chip)."""
    import jax
    import jax.numpy as jnp
    from multi_orbslam3_jax.opt import global_ba, local_ba
    from multi_orbslam3_jax.pipeline.tracking import level_inv_sigma2
    if server is None:
        return {}
    m = server.m
    Kc, N = m.kf_mp.shape
    obs_kf = jnp.repeat(jnp.arange(Kc, dtype=jnp.int32), N)
    obs_pt_raw = m.kf_mp.reshape(-1)
    obs_valid = (obs_pt_raw >= 0) & m.kf_feat_valid.reshape(-1) & \
        m.kf_valid.repeat(N)
    obs = local_ba.BAObservations(
        kf=obs_kf, pt=jnp.where(obs_pt_raw >= 0, obs_pt_raw, 0),
        uv=m.kf_uv.reshape(-1, 2),
        inv_sigma2=level_inv_sigma2(m.kf_level.reshape(-1),
                                    server.cfg.orb.scale_factor),
        valid=obs_valid)
    fixed = ~m.kf_valid
    run = lambda: global_ba.global_bundle_adjust(  # noqa: E731
        m.kf_pose, fixed, m.mp_pos, m.mp_valid, obs, server.K,
        iters=2, cg_iters=iters // 2)
    jax.block_until_ready(run().poses)          # compile
    t0 = time.perf_counter()
    jax.block_until_ready(run().poses)
    wall = time.perf_counter() - t0
    n_obs = int(np.asarray(obs_valid).sum())
    return {"gba_iters_per_s": round(iters / wall, 2),
            "cg_iters": iters, "wall_s": round(wall, 3), "n_obs": n_obs}


def bench_gba_large(n_kf: int = 1024, n_mp: int = 32768,
                    n_feat: int = 256, iters: int = 4,
                    cg_iters: int = 25) -> Dict:
    """Global BA at production arena scale: >=1024 KFs / >=32k
    landmarks with realistic observation density, on one device,
    reporting PCG iterations/s, chi2 before/after and device memory.
    The loop-correction side has test_correct_loop_arena_scale; this is
    the GBA twin."""
    from multi_orbslam3_jax.eval import device
    from multi_orbslam3_jax.eval.gba_scaling import (make_server_arena,
                                                     measure_gba)
    server = make_server_arena(n_kf=n_kf, n_mp=n_mp, n_feat=n_feat,
                               n_agents=4)
    n_obs = int(np.asarray((server.m.kf_mp >= 0)
                           & server.m.kf_feat_valid).sum())
    report, _, _ = measure_gba(server, distributed=False, iters=iters,
                               cg_iters=cg_iters)
    return {"n_kf": n_kf, "n_mp": n_mp, "n_obs": n_obs, **report,
            "peak_bytes_in_use": device.peak_bytes()}


def bench_vocab_selectivity(n_worlds: int = 30, n_frames: int = 18,
                            seed0: int = 500) -> Dict:
    """Place-recognition selectivity: the bundled k10-L4 (10k words) vs
    k10-L5 (100k words) vocabularies on HELD-OUT worlds (seeds disjoint
    from the training corpus), at a multi-hundred-KF database size.
    Protocol: store every even frame of
    every world in one shared database; query with the odd frames; a
    query's true match is a stored frame of the SAME world within 2
    frames. Reports top-1 recall and the mean true/false score margin
    per vocabulary."""
    import jax.numpy as jnp
    from multi_orbslam3_jax.bow import database as dbm
    from multi_orbslam3_jax.bow import vocabulary as vocm
    from multi_orbslam3_jax.dataio import synthetic
    from multi_orbslam3_jax.frontend import extractor

    c = cfg.synthetic_mono()
    frames = []         # (world, frame_idx, desc, valid)
    for w in range(n_worlds):
        seq = synthetic.make_sequence(
            c, n_frames=n_frames, n_points=700, seed=seed0 + w,
            trajectory="circle" if w % 2 else "forward",
            phase=0.25 * (w % 6))
        for i in range(n_frames):
            f = extractor.extract_features(
                jnp.asarray(seq.images[i], jnp.float32), c)
            frames.append((w, i, f.desc, f.valid))

    out: Dict = {"db_size": 0}
    for name, (b, L) in (("L4_10k", (10, 4)), ("L5_100k", (10, 5))):
        voc = vocm.default_vocabulary(b, L)
        stored = [(w, i, d, v) for (w, i, d, v) in frames if i % 2 == 0]
        queries = [(w, i, d, v) for (w, i, d, v) in frames if i % 2 == 1]
        db = dbm.KeyframeDatabase.empty(len(stored), voc.n_words)
        meta = []
        for slot, (w, i, d, v) in enumerate(stored):
            db, _ = dbm.add_keyframe_bow(db, voc, jnp.int32(slot), d, v)
            meta.append((w, i))
        meta = np.asarray(meta)
        hits, margins = 0, []
        for (w, i, d, v) in queries:
            scores = np.asarray(dbm.query(
                db, voc, d, v, jnp.zeros(len(stored), bool)))
            top = int(np.argmax(scores))
            true_mask = (meta[:, 0] == w) & (np.abs(meta[:, 1] - i) <= 2)
            if true_mask[top]:
                hits += 1
            best_true = float(scores[true_mask].max()) \
                if true_mask.any() else 0.0
            best_false = float(scores[~true_mask].max()) \
                if (~true_mask).any() else 1e-9
            margins.append(best_true / max(best_false, 1e-9))
        out["db_size"] = len(stored)
        out[name] = {"top1_recall": round(hits / len(queries), 3),
                     "margin": round(float(np.mean(margins)), 3)}
    return out


def bench_mini_asl(n_frames: int = 80, seed: int = 41) -> Dict:
    """Scored EuRoC-layout drill: render a
    synthetic ground-truth sequence, materialize it as a miniature ASL
    tree (mav0/cam0 PNGs + csv, epoch-scale nanosecond stamps), then run
    the REAL dataset-ingest path — euroc.EurocSequence -> bench_euroc —
    so loader, csv parsing, PNG decode, and timestamp normalization are
    measured every round, exactly like a real EuRoC run would be
    (ros/launch/Client0_euroc.launch:6)."""
    import shutil
    import tempfile
    from multi_orbslam3_jax.dataio import mini_asl, synthetic
    c = _euroc_scale_config()
    seq = synthetic.make_sequence(c, n_frames=n_frames, n_points=1200,
                                  seed=seed, trajectory="forward")
    root = tempfile.mkdtemp(prefix="mini_asl_")
    try:
        mini_asl.write_mini_asl(root, seq)
        out = bench_euroc(root, n_frames=n_frames) or {}
        out["layout"] = "asl"
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def bench_euroc(root: str, n_frames: int = 600) -> Optional[Dict]:
    """EuRoC mono run when a dataset directory exists (ASL layout).
    Ground truth from mav0/state_groundtruth_estimate0/data.csv."""
    import csv
    import os
    from multi_orbslam3_jax.dataio import euroc
    from multi_orbslam3_jax.pipeline.system import MonoSlam, TrackState
    if not euroc.available(root):
        return None
    c = _euroc_scale_config()
    seq = euroc.EurocSequence(root, max_frames=n_frames)
    slam = MonoSlam(c, enable_loop_closing=True)
    states, ts_list = [], []
    t0 = time.perf_counter()
    for t, img in seq:
        states.append(slam.process_frame(img, t))
        ts_list.append(t)
    wall = time.perf_counter() - t0
    out = {"fps": round(len(states) / wall, 2), "frames": len(states)}
    gt_path = os.path.join(root, "mav0", "state_groundtruth_estimate0",
                           "data.csv")
    if os.path.exists(gt_path):
        rows = []
        with open(gt_path) as f:
            for row in csv.reader(f):
                if row and not row[0].startswith("#"):
                    rows.append([float(x) for x in row[:8]])
        gt = np.asarray(rows)
        gt_t = gt[:, 0] * 1e-9
        ok_idx = [i for i, s in enumerate(states) if s == TrackState.OK]
        if len(ok_idx) >= 10:
            est = np.stack([slam.trajectory[i][1] for i in ok_idx])
            e = ate.camera_centers(est)
            g = np.stack([gt[np.argmin(np.abs(gt_t - ts_list[i])), 1:4]
                          for i in ok_idx])
            out["ate_rmse"] = round(ate.ate_rmse(e, g), 4)
            out["frames_ok"] = len(ok_idx)
    return out


def bench_kernels(seed: int = 0) -> Dict:
    """The frontend's two hot device operations at EuRoC width, compared
    bit for bit with the NumPy references (integer inputs make every
    step exact, so the comparison is equality) and timed on the device:

    - FAST-9/16 score + 3x3 NMS at every pyramid level of a 752x480
      frame (random integer intensities), per level and as the whole
      pyramid in one program;
    - the masked Hamming matrix of 16384 map x 1024 frame descriptors,
      and that matrix reduced to each row's best distance (how tracking
      uses it).

    ``*_ms`` is device time per call from a profiler trace
    (``device.device_busy_ms``); ``ok`` is False when any result differs
    from its reference."""
    import jax
    import jax.numpy as jnp
    from multi_orbslam3_jax.eval import device
    from multi_orbslam3_jax.frontend import fast as fastm
    from multi_orbslam3_jax.frontend import matcher, pyramid, reference
    rng = np.random.RandomState(seed)
    o = cfg.ORBConfig()
    thr = o.fast_threshold_min

    def fast_xla(x):
        return fastm.nms3x3(fastm.fast_score(x, thr))

    levels = [jnp.asarray(rng.randint(0, 256, s).astype(np.float32))
              for s in pyramid.level_shapes(480, 752, o.n_levels,
                                            o.scale_factor)]
    one_level = jax.jit(fast_xla)
    per_level = []
    for im in levels:
        ref = reference.fast_score_nms(np.asarray(im), thr)
        per_level.append({
            "shape": list(im.shape),
            "equal": bool(np.array_equal(np.asarray(one_level(im)), ref)),
            "corners": int((ref > 0).sum()),
            "ms": device.device_busy_ms(one_level, im)})
    whole = jax.jit(lambda ims: [fast_xla(x) for x in ims])
    out: Dict = {"exact_integer_compare": True,
                 "fast_levels": per_level,
                 "fast_pyramid_ms": device.device_busy_ms(whole, levels)}

    n_map, n_feat = 16384, 1024
    d1 = rng.randint(0, 2 ** 32, (n_map, 8), dtype=np.uint32)
    d2 = rng.randint(0, 2 ** 32, (n_feat, 8), dtype=np.uint32)
    v1 = rng.rand(n_map) < 0.7
    v2 = rng.rand(n_feat) < 0.9

    def masked(a, va, b, vb):
        return jnp.where(va[:, None] & vb[None, :],
                         matcher.hamming_matrix(a, b), matcher.BIG)

    args = tuple(jnp.asarray(x) for x in (d1, v1, d2, v2))
    ref = np.where(v1[:, None] & v2[None, :],
                   reference.hamming_matrix(d1, d2), int(matcher.BIG))
    masked_j = jax.jit(masked)
    row_min = jax.jit(lambda *a: jnp.min(masked(*a), axis=1))
    out["hamming"] = {
        "shape": [n_map, n_feat],
        "equal": bool(np.array_equal(np.asarray(masked_j(*args)), ref)),
        "matrix_ms": device.device_busy_ms(masked_j, *args),
        "row_min_ms": device.device_busy_ms(row_min, *args)}
    out["ok"] = all(lv["equal"] for lv in per_level) \
        and out["hamming"]["equal"]
    return out


def bench_codec(seed: int = 0) -> Dict:
    """Wire-codec round-trip on the host at vicinity-downlink scale (50
    KFs), native C++ vs the pure-Python twin vs np.savez. Both codec
    impls are memcpy-bound and equivalent (numpy's tobytes/frombuffer/
    crc32 are already C); the win over savez is the zero-copy decode +
    CRC integrity."""
    import io
    import json as _json

    from multi_orbslam3_jax.collab import codec
    rng = np.random.RandomState(seed)
    arrays = {
        "uv": rng.rand(50, 1024, 2).astype(np.float32),
        "desc": rng.randint(0, 2 ** 32, (50, 1024, 8)).astype(np.uint32),
        "level": rng.randint(0, 8, (50, 1024)).astype(np.int32),
        "valid": rng.rand(50, 1024) > 0.2,
        "T": rng.rand(50, 4, 4).astype(np.float32),
    }
    meta = {"agent": 0, "seq": 1}

    def timeit_host(fn, n=50):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return round((time.perf_counter() - t0) / n * 1e3, 3)

    out: Dict = {"native_available": codec.native_available()}
    frame = codec.pack(meta, arrays)
    out["frame_mb"] = round(len(frame) / 2 ** 20, 2)
    out["rt_ms"] = timeit_host(lambda: codec.unpack(codec.pack(meta, arrays)))
    items = [(k.encode(), v) for k, v in arrays.items()]
    mb = _json.dumps(meta).encode()
    out["rt_py_ms"] = timeit_host(
        lambda: codec._unpack_py(codec._pack_py(mb, items)))

    def savez_rt():
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        with np.load(io.BytesIO(buf.getvalue())) as z:
            return {k: z[k] for k in z.files}
    out["rt_savez_ms"] = timeit_host(savez_rt)
    return out
