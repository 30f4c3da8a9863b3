"""Collaborative-server checkpoint/resume: full session state (arena,
inverted file, per-agent books, in-flight payloads) survives a save/load
cycle and the resumed server keeps serving (the reference's SaveMap path
is dead code — src/ClientHandler.cc:153-167; here it's first-class)."""

import os

import numpy as np

from multi_orbslam3_jax.eval.gba_scaling import make_server_arena


def test_checkpoint_roundtrip(tmp_path):
    server = make_server_arena(n_kf=16, n_mp=512, n_feat=64, n_agents=2)
    # dirty up host state so the round-trip is non-trivial
    b0 = server.agents[0]
    b0.kf_l2s = {3: 7, 4: 9}
    b0.mp_l2s = {10: 20}
    b0.map_id = 1
    b0.inertial = True
    b0.next_seq = 17
    b0.erased_kf_tomb = {2, 5}
    b0.pending = [b"payload-a", b"payload-b"]
    b0.ooo = {19: b"future-frame"}
    server.stats["loops"] = 3
    server._next_map_id = 4
    server.kf_map[:4] = 2

    path = os.path.join(str(tmp_path), "server_ckpt.npz")
    server.save_checkpoint(path)

    fresh = make_server_arena(n_kf=16, n_mp=512, n_feat=64, n_agents=2,
                              seed=5)   # different state before load
    fresh.load_checkpoint(path)

    for name in server.m._fields:
        a = np.asarray(getattr(server.m, name))
        b = np.asarray(getattr(fresh.m, name))
        assert np.array_equal(a, b), name
    assert np.array_equal(fresh.kf_map, server.kf_map)
    assert np.array_equal(fresh.kf_local, server.kf_local)
    assert np.array_equal(np.asarray(fresh.db.word),
                          np.asarray(server.db.word))
    assert np.allclose(np.asarray(fresh.db.norm),
                       np.asarray(server.db.norm))
    fb = fresh.agents[0]
    assert fb.kf_l2s == {3: 7, 4: 9} and fb.mp_l2s == {10: 20}
    assert fb.map_id == 1 and fb.inertial and fb.next_seq == 17
    assert fb.erased_kf_tomb == {2, 5}
    assert fb.pending == [b"payload-a", b"payload-b"]
    assert fb.ooo == {19: b"future-frame"}
    assert fresh.stats["loops"] == 3 and fresh._next_map_id == 4

    # the resumed server still serves: a comm cycle + GBA run work
    fresh.comm_cycle()
    fresh.run_global_ba(iters=1, cg_iters=5, distributed=False)
    assert bool(np.all(np.isfinite(np.asarray(fresh.m.kf_pose))))
    assert fresh.stats["gba_runs"] == server.stats["gba_runs"] + 1
