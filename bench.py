"""Benchmark: FULL-SYSTEM accuracy + throughput across BASELINE configs.

Prints ONE JSON line on stdout. Primary metric stays tracked
frames/s/chip (vs_baseline = fps / the reference's 20 fps real-time
envelope, BASELINE.md), and the line carries per-config full-system
results for the CORE configs:

- mono / stereo / mono_inertial / collab_2agent: ATE RMSE (Sim3-aligned;
  SE3 for stereo) over OK-tracked frames of a synthetic ground-truth
  sequence, plus fps measured over the WHOLE pipeline (keyframe
  insertion, triangulation, fusion, local BA, loop closing included).
  mono/stereo/mono_inertial use the two-pass protocol (pass 1 warms the
  XLA caches, pass 2 is timed). The collab configs run a SINGLE pass
  inside the driver budget and report both fps definitions:
  total_fps_wall (frames/wall incl. compiles) and total_fps_tail
  (steady state over the tail two-thirds; collab's headline total_fps).

The JSON line is re-printed after every config, so a run cut by a time
limit keeps the configs that finished. Every line names the device it
ran on and each card's name and power limit (nvidia-smi); without a
GPU the bench exits non-zero before measuring
anything. Extra studies — GBA iters/s on the 2-agent arena, the kernel
micro-bench, EuRoC (if a dataset exists) — run only under
MO3_BENCH_FULL=1 and report on stderr, keeping stdout to the JSON lines.

The reference's validation story is trajectory export + ATE
(src/ServerSystem.cc:134-185); this bench reproduces it in-process.
"""

from __future__ import annotations

import json
import os
import sys


def main() -> None:
    from multi_orbslam3_jax.eval import device
    dev = {**device.require_gpu(),
           "cards": device.parse_cards(device.query_cards())}
    from multi_orbslam3_jax.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from multi_orbslam3_jax.eval import benchmarks as B

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    configs = {}

    def emit():
        # re-printed after every config: the LAST JSON line on stdout
        # is the result, so a timeout mid-config keeps finished configs
        fps = configs.get("mono", {}).get("fps", 0.0)
        print(json.dumps({
            "metric": "tracked_frames_per_s_per_chip",
            "value": fps,
            "unit": "frames/s",
            "vs_baseline": round(fps / 20.0, 3),
            "device": dev,
            "configs": configs,
        }), flush=True)

    log("bench: mono (full system, loop closing on)...")
    configs["mono"] = B.bench_mono()
    log(f"  -> {configs['mono']}")
    emit()
    log("bench: stereo...")
    configs["stereo"] = B.bench_stereo()
    log(f"  -> {configs['stereo']}")
    emit()
    log("bench: mono_inertial (EuRoC T_bc)...")
    configs["mono_inertial"] = B.bench_mono_inertial()
    log(f"  -> {configs['mono_inertial']}")
    emit()
    log("bench: mini-ASL (EuRoC-layout dataset-ingest drill)...")
    try:
        configs["mini_asl"] = B.bench_mini_asl()
        log(f"  -> {configs['mini_asl']}")
    except Exception as e:  # noqa: BLE001
        configs["mini_asl"] = {"error": str(e)[:300]}
    emit()
    log("bench: collab 2-agent (150 frames, GBA on, single pass)...")
    # single pass: the two-pass warmup protocol doubles the slowest
    # config; steady-state fps comes from the tail frames
    configs["collab_2agent"], server = B.bench_collab(
        n_agents=2, warmup=False)
    log(f"  -> {configs['collab_2agent']}")
    emit()
    # heavier configs, cheapest first, emit() after each so a timeout
    # keeps whatever finished
    log("bench: global BA at arena scale (1024 KF / 32k MP)...")
    try:
        configs["gba_large"] = B.bench_gba_large()
        log(f"  -> {configs['gba_large']}")
    except Exception as e:  # noqa: BLE001
        configs["gba_large"] = {"error": str(e)[:300]}
    emit()
    log("bench: collab 4-agent (BASELINE config #5, 100 frames)...")
    try:
        configs["collab_4agent"], server4 = B.bench_collab(
            n_agents=4, n_frames=100, warmup=False)
        log(f"  -> {configs['collab_4agent']}")
    except Exception as e:  # noqa: BLE001
        configs["collab_4agent"] = {"error": str(e)[:300]}
    emit()
    log("bench: vocabulary selectivity (10k vs 100k words)...")
    try:
        configs["vocab"] = B.bench_vocab_selectivity()
        log(f"  -> {configs['vocab']}")
    except Exception as e:  # noqa: BLE001
        configs["vocab"] = {"error": str(e)[:300]}
    emit()

    if os.environ.get("MO3_BENCH_FULL") != "1":
        return

    # ---- full mode: extra studies, results on stderr only -------------
    extra = {}
    log("bench[full]: global BA iters/s (2-agent arena)...")
    extra["gba"] = B.bench_gba(server)
    log(f"  -> {extra['gba']}")
    log("bench[full]: frontend kernels vs NumPy references...")
    extra["kernels"] = B.bench_kernels()
    log(f"  -> {extra['kernels']}")
    extra["codec_host"] = B.bench_codec()

    euroc_root = os.environ.get(
        "EUROC_ROOT", os.path.join(os.path.dirname(__file__),
                                   "datasets", "euroc", "MH01"))
    euroc = B.bench_euroc(euroc_root)
    if euroc:
        extra["euroc_mono"] = euroc

    log("FULL_RESULTS " + json.dumps(extra))


if __name__ == "__main__":
    main()
