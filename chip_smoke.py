#!/usr/bin/env python
"""Run the SLAM engine end to end on an NVIDIA GPU and check the results.

Usage:
    python chip_smoke.py          # one card, every phase below
    python chip_smoke.py --four   # four cards: sharded vs one-card GBA

One card, in this order, through the classes the apps and bench.py use,
at the EuRoC-scale configuration (752x480 or 640x480 frames, 1024 ORB
features, 8 levels, 512 keyframes and 16384 landmarks per agent):

  kernels        FAST score+NMS at every pyramid level and the masked
                 16384x1024 Hamming matrix, equal to their NumPy
                 references; device time of each
  mono           MonoSlam.process_frame_pipelined, 120 frames
  stereo         StereoSlam, 80 frames
  mono_inertial  MonoInertialSlam with the EuRoC T_bc, 90 frames
  collab_2agent  two CollabClients + CollabServer in one process, 150
                 frames, global BA on
  gba_large      CollabServer.run_global_ba on a 1024-KF / 32768-landmark
                 arena

Each phase prints one JSON line with its gate, set-up (compile) time
apart from run time, and the process's peak device bytes so far. A
missed gate or an exception fails the run. The last line is
``{"ok": true, "device": {...}}``; without a GPU the script exits
non-zero before any phase.

``--four`` runs only the gba_large arena's global BA sharded over four
cards (``distributed=True``, a 1-D ("obs",) mesh) against the same solve
on card 0, and gates chi2 (1e-3 relative) and poses (``POSE_ATOL``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# sharded vs one-card poses: the psum reductions sum in another order,
# and 100 PCG iterations on a 1024-KF arena carry that into the last
# float32 digits of poses whose translations reach ~150 m
POSE_ATOL = 5e-3
CHI2_RTOL = 1e-3


def _emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def _tracked_gate(rec: dict, frames: int, ate_frac: float) -> bool:
    """>=90% of frames tracked and ATE below ate_frac x span."""
    return (rec.get("frames_ok", 0) >= 0.9 * frames
            and "ate_rmse" in rec
            and rec["ate_rmse"] < ate_frac * rec["span"])


def phase_kernels() -> dict:
    from multi_orbslam3_jax.eval import benchmarks as B
    rec = B.bench_kernels()
    return {"gate": "FAST per level and masked Hamming equal to NumPy "
                    "(exact integer comparison)", "pass": rec.pop("ok"),
            **rec}


def phase_mono() -> dict:
    from multi_orbslam3_jax.eval import benchmarks as B
    rec = B.bench_mono(n_frames=120)
    return {"gate": ">=90% tracked, ATE < 0.02 x span",
            "pass": _tracked_gate(rec, 120, 0.02), **rec}


def phase_stereo() -> dict:
    from multi_orbslam3_jax.eval import benchmarks as B
    rec = B.bench_stereo(n_frames=80)
    return {"gate": ">=90% tracked, ATE < 0.02 x span",
            "pass": _tracked_gate(rec, 80, 0.02), **rec}


def phase_mono_inertial() -> dict:
    from multi_orbslam3_jax.eval import benchmarks as B
    rec = B.bench_mono_inertial(n_frames=90)
    return {"gate": ">=90% tracked, ATE < 0.05 x span, IMU initialized",
            "pass": _tracked_gate(rec, 90, 0.05)
            and rec["imu_initialized"], **rec}


def phase_collab_2agent() -> dict:
    from multi_orbslam3_jax.eval import benchmarks as B
    frames = 150
    rec, _ = B.bench_collab(n_agents=2, n_frames=frames, warmup=True)
    agents = [rec.get(f"agent{a}", {}) for a in range(2)]
    ok = rec["merges"] >= 1 and all(_tracked_gate(a, frames, 0.02)
                                    for a in agents)
    return {"gate": "per agent >=90% tracked and ATE < 0.02 x span, "
                    ">=1 merge", "pass": ok, **rec}


def phase_gba_large() -> dict:
    from multi_orbslam3_jax.eval import benchmarks as B
    rec = B.bench_gba_large()
    return {"gate": "finite poses and points, chi2 not increasing",
            "pass": rec["finite"] and rec["chi2"] <= rec["chi2_in"], **rec}


PHASES = (("kernels", phase_kernels), ("mono", phase_mono),
          ("stereo", phase_stereo), ("mono_inertial", phase_mono_inertial),
          ("collab_2agent", phase_collab_2agent),
          ("gba_large", phase_gba_large))


def run_four() -> bool:
    """Sharded GBA over four cards against the one-card solve."""
    import jax
    import numpy as np

    from multi_orbslam3_jax.eval import device
    from multi_orbslam3_jax.eval.gba_scaling import (make_server_arena,
                                                     measure_gba)
    if len(jax.devices()) < 4:
        raise SystemExit(f"--four needs 4 GPUs, found {len(jax.devices())}")
    res = {}
    for distributed in (False, True):
        server = make_server_arena(n_kf=1024, n_mp=32768, n_feat=256,
                                   n_agents=4)
        res[distributed] = measure_gba(server, distributed=distributed)
    single, sharded = res[False][0], res[True][0]
    chi2_rel = abs(sharded["chi2"] - single["chi2"]) / abs(single["chi2"])
    pose_diff = float(np.max(np.abs(res[True][1] - res[False][1])))
    point_diff = float(np.max(np.abs(res[True][2] - res[False][2])))
    ok = (single["finite"] and sharded["finite"]
          and chi2_rel <= CHI2_RTOL and pose_diff <= POSE_ATOL)
    _emit({"phase": "gba_four",
           "gate": f"chi2 within {CHI2_RTOL} relative, poses within "
                   f"{POSE_ATOL} absolute", "pass": ok,
           "single_card": single, "sharded_4": sharded,
           "chi2_rel_diff": chi2_rel, "pose_max_abs_diff": pose_diff,
           "point_max_abs_diff": point_diff,
           "peak_bytes_in_use": [device.peak_bytes(i) for i in range(4)]})
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="only the four-card sharded global-BA comparison")
    args = ap.parse_args(argv)

    from multi_orbslam3_jax.eval import device
    dev = device.require_gpu()
    from multi_orbslam3_jax.utils.cache import enable_compilation_cache
    cache = enable_compilation_cache()
    cards = device.query_cards()
    print(cards, flush=True)
    _emit({"phase": "start", "device": dev,
           "cards": device.parse_cards(cards), "compilation_cache": cache})

    if args.four:
        ok = run_four()
    else:
        ok = True
        for name, fn in PHASES:
            t0 = time.perf_counter()
            rec = fn()
            rec = {"phase": name, **rec,
                   "phase_wall_s": round(time.perf_counter() - t0, 2),
                   "peak_bytes_in_use": device.peak_bytes()}
            _emit(rec)
            ok = ok and rec["pass"]
    if not ok:
        print("chip_smoke: a gate failed", file=sys.stderr)
        return 1
    _emit({"ok": True, "device": device.describe()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
