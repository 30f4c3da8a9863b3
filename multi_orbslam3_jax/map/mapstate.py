"""MapState: the device-resident SLAM map and its functional update ops.

Replaces the reference's Map/KeyFrame/MapPoint object graph (src/Map.cc,
src/KeyFrame.cc, src/MapPoint.cc) with fixed-capacity arrays:

- keyframe slot k holds pose + the full feature batch of the frame that
  created it (reference KeyFrame keeps mvKeysUn/mDescriptors the same way);
- ``kf_mp`` maps (kf, feature) -> map-point slot (-1 = none) and is the ONLY
  association storage; MP->KF observation lists, covisibility weights
  (KeyFrame::UpdateConnections, KeyFrame.cc:490-621) and BA observation
  blocks are all derived from it by masked reductions;
- erasure (SetBadFlag, KeyFrame.cc:722-864) is a cleared validity bit; slots
  are never reused within a session, matching the reference's monotonically
  increasing ids;
- ``kf_pose_locked`` mirrors the reference's ``mbPoseLock`` server-wins rule
  (KeyFrame.cc:178-220): locked poses are only overwritten by global
  optimization results, never by odometry updates.

Identity: slot index == local id. For collaboration each map also stores
``kf_agent``/``mp_agent`` giving the reference's (clientId, id) idpair
(include/Datatypes.h:25) as (agent, slot).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from multi_orbslam3_jax.frontend.extractor import FrameFeatures

NO_MP = -1


class MapState(NamedTuple):
    # --- keyframes ---
    kf_pose: jnp.ndarray         # (K, 4, 4) T_cw
    kf_valid: jnp.ndarray        # (K,) bool
    kf_map_id: jnp.ndarray       # (K,) int32 sub-map id (client Atlas)
    kf_timestamp: jnp.ndarray    # (K,) float32
    kf_agent: jnp.ndarray        # (K,) int32 owning agent
    kf_parent: jnp.ndarray       # (K,) int32 spanning-tree parent (-1 root)
    kf_pose_locked: jnp.ndarray  # (K,) bool server-correction lock
    kf_uv: jnp.ndarray           # (K, N, 2) undistorted keypoints
    kf_desc: jnp.ndarray         # (K, N, 8) uint32
    kf_level: jnp.ndarray        # (K, N) int32
    kf_angle: jnp.ndarray        # (K, N) float32
    kf_feat_valid: jnp.ndarray   # (K, N) bool
    kf_mp: jnp.ndarray           # (K, N) int32 map-point slot or NO_MP
    kf_ur: jnp.ndarray           # (K, N) f32 stereo right-u (reference
                                 # mvuRight, src/Frame.cc:785-965); -1 = mono
                                 # or unmatched feature
    kf_cam: jnp.ndarray          # (K, 4) f32 per-KF pinhole (fx, fy, cx, cy)
                                 # — heterogeneous agents carry their own
                                 # (rectified) intrinsics (reference builds a
                                 # per-client camera model, ClientHandler.cc:
                                 # 26-66); all-zero row = "use the caller's
                                 # default camera"
    # --- map points ---
    mp_pos: jnp.ndarray          # (P, 3)
    mp_valid: jnp.ndarray        # (P,) bool
    mp_map_id: jnp.ndarray       # (P,) int32 sub-map id
    mp_agent: jnp.ndarray        # (P,) int32
    mp_desc: jnp.ndarray         # (P, 8) uint32 representative descriptor
    mp_normal: jnp.ndarray       # (P, 3) mean viewing direction
    mp_min_dist: jnp.ndarray     # (P,) scale-invariance range
    mp_max_dist: jnp.ndarray     # (P,)
    mp_ref_kf: jnp.ndarray       # (P,) int32 reference keyframe slot
    mp_found: jnp.ndarray        # (P,) int32 found counter
    mp_visible: jnp.ndarray      # (P,) int32 visible counter
    mp_redirect: jnp.ndarray     # (P,) int32 fusion forwarding pointer
                                 # (reference MapPoint::GetReplaced,
                                 # src/MapPoint.cc:367): replace_mappoint
                                 # records old -> new here so host
                                 # bookkeeping (server id maps, client
                                 # mirrors) can follow the survivor;
                                 # -1 = live (never replaced)
    # --- counters ---
    n_kf: jnp.ndarray            # () int32 next free KF slot
    n_mp: jnp.ndarray           # () int32 next free MP slot
    active_map: jnp.ndarray      # () int32 current sub-map (Atlas active)

    @property
    def max_kf(self) -> int:
        return self.kf_pose.shape[0]

    @property
    def max_mp(self) -> int:
        return self.mp_pos.shape[0]

    @property
    def n_feat(self) -> int:
        return self.kf_uv.shape[1]


def empty_map(max_kf: int, max_mp: int, n_feat: int) -> MapState:
    f32, i32 = jnp.float32, jnp.int32
    return MapState(
        kf_pose=jnp.tile(jnp.eye(4, dtype=f32), (max_kf, 1, 1)),
        kf_valid=jnp.zeros(max_kf, bool),
        kf_map_id=jnp.zeros(max_kf, i32),
        kf_timestamp=jnp.zeros(max_kf, f32),
        kf_agent=jnp.zeros(max_kf, i32),
        kf_parent=jnp.full((max_kf,), -1, i32),
        kf_pose_locked=jnp.zeros(max_kf, bool),
        kf_uv=jnp.zeros((max_kf, n_feat, 2), f32),
        kf_desc=jnp.zeros((max_kf, n_feat, 8), jnp.uint32),
        kf_level=jnp.zeros((max_kf, n_feat), i32),
        kf_angle=jnp.zeros((max_kf, n_feat), f32),
        kf_feat_valid=jnp.zeros((max_kf, n_feat), bool),
        kf_mp=jnp.full((max_kf, n_feat), NO_MP, i32),
        kf_ur=jnp.full((max_kf, n_feat), -1.0, f32),
        kf_cam=jnp.zeros((max_kf, 4), f32),
        mp_pos=jnp.zeros((max_mp, 3), f32),
        mp_valid=jnp.zeros(max_mp, bool),
        mp_map_id=jnp.zeros(max_mp, i32),
        mp_agent=jnp.zeros(max_mp, i32),
        mp_desc=jnp.zeros((max_mp, 8), jnp.uint32),
        mp_normal=jnp.zeros((max_mp, 3), f32),
        mp_min_dist=jnp.zeros(max_mp, f32),
        mp_max_dist=jnp.zeros(max_mp, f32),
        mp_ref_kf=jnp.full((max_mp,), -1, i32),
        mp_found=jnp.zeros(max_mp, i32),
        mp_visible=jnp.zeros(max_mp, i32),
        mp_redirect=jnp.full((max_mp,), -1, i32),
        n_kf=jnp.int32(0),
        n_mp=jnp.int32(0),
        active_map=jnp.int32(0),
    )


@jax.jit
def add_keyframe(m: MapState, feats: FrameFeatures, pose: jnp.ndarray,
                 timestamp, mp_assoc: jnp.ndarray, parent,
                 agent=0, u_r=None, cam4=None) -> tuple[MapState, jnp.ndarray]:
    """Insert a keyframe at the next free slot.

    mp_assoc: (N,) int32 map-point slot per feature (NO_MP where none) —
    the tracking thread's current associations (reference CreateNewKeyFrame,
    src/Tracking.cc:2952). u_r: (N,) stereo right-u per feature (reference
    mvuRight; -1 where unmatched), None for mono frames. cam4: (4,) the
    owning camera's (fx, fy, cx, cy); None leaves the all-zero
    "default camera" marker.
    Returns (new_map, kf_slot).
    """
    if u_r is None:
        u_r = jnp.full((m.n_feat,), -1.0, jnp.float32)
    if cam4 is None:
        cam4 = jnp.zeros(4, jnp.float32)
    k = m.n_kf
    in_cap = k < m.max_kf
    k_safe = jnp.minimum(k, m.max_kf - 1)
    sel = lambda new, old: jnp.where(in_cap, new, old)  # noqa: E731

    m = m._replace(
        kf_pose=m.kf_pose.at[k_safe].set(sel(pose, m.kf_pose[k_safe])),
        kf_valid=m.kf_valid.at[k_safe].set(sel(True, m.kf_valid[k_safe])),
        kf_map_id=m.kf_map_id.at[k_safe].set(
            sel(m.active_map, m.kf_map_id[k_safe])),
        kf_timestamp=m.kf_timestamp.at[k_safe].set(
            sel(jnp.float32(timestamp), m.kf_timestamp[k_safe])),
        kf_agent=m.kf_agent.at[k_safe].set(
            sel(jnp.int32(agent), m.kf_agent[k_safe])),
        kf_parent=m.kf_parent.at[k_safe].set(
            sel(jnp.int32(parent), m.kf_parent[k_safe])),
        kf_uv=m.kf_uv.at[k_safe].set(sel(feats.uv_und, m.kf_uv[k_safe])),
        kf_desc=m.kf_desc.at[k_safe].set(sel(feats.desc, m.kf_desc[k_safe])),
        kf_level=m.kf_level.at[k_safe].set(sel(feats.level, m.kf_level[k_safe])),
        kf_angle=m.kf_angle.at[k_safe].set(sel(feats.angle, m.kf_angle[k_safe])),
        kf_feat_valid=m.kf_feat_valid.at[k_safe].set(
            sel(feats.valid, m.kf_feat_valid[k_safe])),
        kf_mp=m.kf_mp.at[k_safe].set(sel(mp_assoc, m.kf_mp[k_safe])),
        kf_ur=m.kf_ur.at[k_safe].set(sel(u_r, m.kf_ur[k_safe])),
        kf_cam=m.kf_cam.at[k_safe].set(
            sel(jnp.asarray(cam4, jnp.float32), m.kf_cam[k_safe])),
        n_kf=jnp.where(in_cap, k + 1, k),
    )
    return m, jnp.where(in_cap, k, jnp.int32(-1))


@jax.jit
def add_keyframes_batch(m: MapState, poses: jnp.ndarray,
                        timestamps: jnp.ndarray, agents: jnp.ndarray,
                        parents: jnp.ndarray, assocs: jnp.ndarray,
                        uv: jnp.ndarray, desc: jnp.ndarray,
                        level: jnp.ndarray, angle: jnp.ndarray,
                        feat_valid: jnp.ndarray, count, cams=None
                        ) -> tuple[MapState, jnp.ndarray]:
    """Batch-insert up to B keyframes at consecutive slots — ONE compiled
    program per comm cycle instead of per-KF dispatches (the server-ingest
    hot path; the reference constructs KeyFrames one by one from messages,
    Communicator::ProcessKfInServer, src/Communicator.cc:355-495).

    All inputs are (B, ...) with only rows [0, count) real; padding rows
    are routed to a sacrificial scatter slot. Returns (map, slots (B,))
    with -1 for padding/over-capacity rows.
    """
    B = poses.shape[0]
    if cams is None:
        cams = jnp.zeros((B, 4), jnp.float32)
    idx = jnp.arange(B, dtype=jnp.int32)
    slots = m.n_kf + idx
    ok = (idx < count) & (slots < m.max_kf)
    safe = jnp.where(ok, slots, m.max_kf)      # extended sacrificial row

    def scat(arr, vals):
        ext = jnp.concatenate([arr, jnp.zeros_like(arr[:1])], 0)
        return ext.at[safe].set(vals.astype(arr.dtype))[:m.max_kf]

    m = m._replace(
        kf_pose=scat(m.kf_pose, poses),
        kf_valid=scat(m.kf_valid, jnp.ones(B, bool)),
        kf_map_id=scat(m.kf_map_id,
                       jnp.full((B,), 1, jnp.int32) * m.active_map),
        kf_timestamp=scat(m.kf_timestamp, timestamps),
        kf_agent=scat(m.kf_agent, agents),
        kf_parent=scat(m.kf_parent, parents),
        kf_uv=scat(m.kf_uv, uv),
        kf_desc=scat(m.kf_desc, desc),
        kf_level=scat(m.kf_level, level),
        kf_angle=scat(m.kf_angle, angle),
        kf_feat_valid=scat(m.kf_feat_valid, feat_valid),
        kf_mp=scat(m.kf_mp, assocs),
        kf_ur=scat(m.kf_ur, jnp.full((B, m.n_feat), -1.0, jnp.float32)),
        kf_cam=scat(m.kf_cam, jnp.asarray(cams, jnp.float32)),
        n_kf=m.n_kf + jnp.sum(ok.astype(jnp.int32)),
    )
    return m, jnp.where(ok, slots, jnp.int32(-1))


@jax.jit
def add_mappoints(m: MapState, pos: jnp.ndarray, ok: jnp.ndarray,
                  desc: jnp.ndarray, ref_kf, kf_a, feat_a: jnp.ndarray,
                  kf_b, feat_b: jnp.ndarray, agent=0) -> tuple[MapState, jnp.ndarray]:
    """Batch-insert up to B new map points observed in two keyframes
    (reference LocalMapping::CreateNewMapPoints, src/LocalMapping.cc:520).

    pos: (B, 3) candidate positions; ok: (B,) creation mask; desc: (B, 8);
    feat_a/feat_b: (B,) feature indices in kf_a / kf_b. Returns
    (new_map, slots (B,) int32 with -1 where not created).
    """
    B = pos.shape[0]
    # assign consecutive slots to the ok-entries
    offset = jnp.cumsum(ok.astype(jnp.int32)) - 1
    slots = jnp.where(ok, m.n_mp + offset, NO_MP)
    in_cap = (slots >= 0) & (slots < m.max_mp)
    slots = jnp.where(in_cap, slots, NO_MP)
    slot_safe = jnp.where(slots >= 0, slots, m.max_mp - 1)
    write = slots >= 0

    def upd(arr, val):
        cur = arr[slot_safe]
        shaped = jnp.where(
            write.reshape((B,) + (1,) * (val.ndim - 1)), val, cur)
        return arr.at[slot_safe].set(shaped)

    cam_center = -jnp.einsum("ji,j->i", m.kf_pose[ref_kf, :3, :3],
                             m.kf_pose[ref_kf, :3, 3])
    view = pos - cam_center
    dist = jnp.linalg.norm(view, axis=-1) + 1e-8
    normal = view / dist[:, None]

    m = m._replace(
        mp_pos=upd(m.mp_pos, pos),
        mp_valid=upd(m.mp_valid, jnp.ones(B, bool)),
        mp_map_id=upd(m.mp_map_id, jnp.full((B,), 1, jnp.int32) * m.active_map),
        mp_agent=upd(m.mp_agent, jnp.full((B,), agent, jnp.int32)),
        mp_desc=upd(m.mp_desc, desc),
        mp_normal=upd(m.mp_normal, normal),
        mp_min_dist=upd(m.mp_min_dist, dist * 0.5),
        mp_max_dist=upd(m.mp_max_dist, dist * 2.0),
        mp_ref_kf=upd(m.mp_ref_kf, jnp.full((B,), ref_kf, jnp.int32)),
        n_mp=jnp.minimum(m.n_mp + jnp.sum(ok.astype(jnp.int32)),
                         jnp.int32(m.max_mp)),
    )
    # write associations into both keyframes
    kfmp = m.kf_mp
    kfmp = kfmp.at[kf_a, feat_a].set(jnp.where(write, slots, kfmp[kf_a, feat_a]))
    kfmp = kfmp.at[kf_b, feat_b].set(jnp.where(write, slots, kfmp[kf_b, feat_b]))
    return m._replace(kf_mp=kfmp), slots


def add_mappoints_raw_padded(m: MapState, pos, ok, desc, ref_kf, agent=0):
    """add_mappoints_raw with the batch padded to a power-of-2 class:
    network ingest sees arbitrary batch sizes and every new size is a
    fresh XLA compilation — shape classes bound the compile count.
    Returns slots for the REAL rows only."""
    import numpy as np
    B = int(np.asarray(pos).shape[0])
    Bp = max(8, 1 << (B - 1).bit_length())
    if Bp != B:
        padn = Bp - B
        pos = jnp.concatenate([jnp.asarray(pos, jnp.float32),
                               jnp.zeros((padn, 3), jnp.float32)])
        ok = jnp.concatenate([jnp.asarray(ok, bool),
                              jnp.zeros(padn, bool)])
        desc = jnp.concatenate([jnp.asarray(desc, jnp.uint32),
                                jnp.zeros((padn, 8), jnp.uint32)])
        ref_kf = jnp.concatenate([jnp.asarray(ref_kf, jnp.int32),
                                  jnp.zeros(padn, jnp.int32)])
    m2, slots = add_mappoints_raw(m, pos, ok, desc, ref_kf, agent)
    return m2, slots[:B]


@jax.jit
def add_mappoints_raw(m: MapState, pos: jnp.ndarray, ok: jnp.ndarray,
                      desc: jnp.ndarray, ref_kf: jnp.ndarray,
                      agent=0) -> tuple[MapState, jnp.ndarray]:
    """Batch-insert landmarks WITHOUT writing feature associations — the
    network-ingest path (server builds MapPoints from messages,
    Communicator::ProcessMpInServer; associations arrive separately with
    the keyframe payloads). ref_kf: (B,) per-point reference KF slot."""
    B = pos.shape[0]
    offset = jnp.cumsum(ok.astype(jnp.int32)) - 1
    slots = jnp.where(ok, m.n_mp + offset, NO_MP)
    in_cap = (slots >= 0) & (slots < m.max_mp)
    slots = jnp.where(in_cap, slots, NO_MP)
    slot_safe = jnp.where(slots >= 0, slots, m.max_mp - 1)
    write = slots >= 0

    def upd(arr, val):
        cur = arr[slot_safe]
        shaped = jnp.where(write.reshape((B,) + (1,) * (val.ndim - 1)),
                           val, cur)
        return arr.at[slot_safe].set(shaped)

    ref_safe = jnp.clip(ref_kf, 0, m.max_kf - 1)
    R = m.kf_pose[ref_safe, :3, :3]
    t = m.kf_pose[ref_safe, :3, 3]
    cam_center = -jnp.einsum("bji,bj->bi", R, t)
    view = pos - cam_center
    dist = jnp.linalg.norm(view, axis=-1) + 1e-8
    m = m._replace(
        mp_pos=upd(m.mp_pos, pos),
        mp_valid=upd(m.mp_valid, jnp.ones(B, bool)),
        mp_map_id=upd(m.mp_map_id, jnp.full((B,), 1, jnp.int32) * m.active_map),
        mp_agent=upd(m.mp_agent, jnp.full((B,), agent, jnp.int32)),
        mp_desc=upd(m.mp_desc, desc),
        mp_normal=upd(m.mp_normal, view / dist[:, None]),
        mp_min_dist=upd(m.mp_min_dist, dist * 0.5),
        mp_max_dist=upd(m.mp_max_dist, dist * 2.0),
        mp_ref_kf=upd(m.mp_ref_kf, ref_kf.astype(jnp.int32)),
        n_mp=jnp.minimum(m.n_mp + jnp.sum(ok.astype(jnp.int32)),
                         jnp.int32(m.max_mp)))
    return m, slots


def kf_intrinsics(m: MapState, kf, K_default):
    """Per-keyframe pinhole intrinsics with fallback: a keyframe whose
    kf_cam row was never set (all-zero, e.g. pre-collab single-camera
    sessions) uses the caller's default camera. `kf` may be a scalar slot
    or an index array — the returned PinholeK fields broadcast to its
    shape (every cam.project/unproject consumer broadcasts)."""
    from multi_orbslam3_jax.geometry import camera as _cam
    row = m.kf_cam[kf]
    have = row[..., 0] > 0
    return _cam.PinholeK(
        fx=jnp.where(have, row[..., 0], K_default.fx),
        fy=jnp.where(have, row[..., 1], K_default.fy),
        cx=jnp.where(have, row[..., 2], K_default.cx),
        cy=jnp.where(have, row[..., 3], K_default.cy))


@jax.jit
def covisibility_row(m: MapState, kf: jnp.ndarray) -> jnp.ndarray:
    """Shared-map-point counts between keyframe `kf` and every other KF
    (reference KeyFrame::UpdateConnections weight computation).

    Returns (K,) int32. Built gather-side: one small scatter marks kf's
    landmark membership over P, then every KF's count is a gather + sum
    over its own feature rows — the full (K, P) observation-mask scatter
    (512k updates) never materializes. Jitted: host-loop callers (loop
    closer, server PR) would otherwise pay ~10 eager dispatches per
    call.
    """
    K, N = m.kf_mp.shape
    P = m.max_mp
    row_kf = m.kf_mp[kf]
    row_ok = (row_kf >= 0) & m.kf_feat_valid[kf]
    member = jnp.zeros(P + 1, jnp.float32).at[
        jnp.where(row_ok, row_kf, P)].max(row_ok.astype(jnp.float32))
    member = member * jnp.concatenate(
        [m.mp_valid, jnp.zeros(1, bool)]).astype(jnp.float32)
    ok = (m.kf_mp >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    slot = jnp.where(ok, m.kf_mp, P)                 # (K, N)
    counts = jnp.sum(member[slot], axis=1).astype(jnp.int32)
    counts = counts.at[kf].set(0)
    return counts


def covisibility_matrix(m: MapState, chunk: int = 8192) -> jnp.ndarray:
    """(K, K) shared-observation counts via W = A A^T with the landmark
    axis processed in chunks: the observation mask stays BOOL (1 byte)
    and only a (K, chunk) bf16 cast is live per step, so the 4-agent
    arena (2048 KF x 65k MP) peaks at ~170 MB instead of the 0.5 GB f32
    mask. The per-chunk products are matrix multiplies."""
    obs = kf_mp_mask(m)                       # (K, P) bool
    K, P = obs.shape
    pad = (-P) % chunk
    if pad:
        obs = jnp.pad(obs, ((0, 0), (0, pad)))
    obs_c = obs.reshape(K, -1, chunk).transpose(1, 0, 2)   # (C, K, chunk)

    def body(acc, A):
        Ab = A.astype(jnp.bfloat16)
        return acc + jnp.matmul(Ab, Ab.T,
                                preferred_element_type=jnp.float32), None

    W, _ = jax.lax.scan(body, jnp.zeros((K, K), jnp.float32), obs_c)
    return (W - jnp.diag(jnp.diag(W))).astype(jnp.int32)


def kf_mp_mask(m: MapState) -> jnp.ndarray:
    """(K, P) bool: keyframe k observes map point p. Derived from kf_mp."""
    K, N = m.kf_mp.shape
    P = m.max_mp
    valid = (m.kf_mp >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    slot = jnp.where(valid, m.kf_mp, 0)
    onehot = jnp.zeros((K, P), bool)
    kf_idx = jnp.broadcast_to(jnp.arange(K)[:, None], (K, N))
    onehot = onehot.at[kf_idx.reshape(-1), slot.reshape(-1)].max(
        valid.reshape(-1))
    return onehot & m.mp_valid[None, :]


@jax.jit
def erase_keyframe(m: MapState, kf) -> MapState:
    """Tombstone a keyframe (reference KeyFrame::SetBadFlag). Associations
    from this KF are dropped; children re-parent to the erased KF's parent."""
    parent = m.kf_parent[kf]
    new_parent = jnp.where(m.kf_parent == kf, parent, m.kf_parent)
    return m._replace(
        kf_valid=m.kf_valid.at[kf].set(False),
        kf_mp=m.kf_mp.at[kf].set(jnp.full((m.n_feat,), NO_MP, jnp.int32)),
        kf_parent=new_parent)


@jax.jit
def erase_mappoints(m: MapState, slots: jnp.ndarray) -> MapState:
    """Tombstone map points (reference MapPoint::SetBadFlag): clear validity
    and remove every KF association. slots: (B,) with -1 entries ignored."""
    ok = slots >= 0
    safe = jnp.where(ok, slots, 0)
    mp_valid = m.mp_valid.at[safe].set(jnp.where(ok, False, m.mp_valid[safe]))
    # clear kf_mp entries pointing at erased slots
    erased = jnp.zeros((m.max_mp + 1,), bool).at[safe].set(ok)
    point = jnp.where(m.kf_mp >= 0, m.kf_mp, m.max_mp)
    kf_mp = jnp.where(erased[point], NO_MP, m.kf_mp)
    return m._replace(mp_valid=mp_valid, kf_mp=kf_mp)


@jax.jit
def update_found_visible(m: MapState, feat_mp: jnp.ndarray,
                         visible: jnp.ndarray) -> MapState:
    """Per-frame landmark statistics (reference MapPoint::IncreaseFound /
    IncreaseVisible, src/MapPoint.cc — the found/visible ratio feeds
    MapPointCulling). feat_mp: (N,) inlier landmark slot per frame feature
    (-1 none); visible: (P,) bool mask of landmarks that projected into the
    frame's frustum this frame."""
    ok = feat_mp >= 0
    safe = jnp.where(ok, feat_mp, 0)
    found = m.mp_found.at[safe].add(ok.astype(jnp.int32))
    vis = m.mp_visible + (visible & m.mp_valid).astype(jnp.int32)
    return m._replace(mp_found=found, mp_visible=vis)


@functools.partial(jax.jit,
                   static_argnames=("max_obs", "scale_factor", "n_levels"))
def refresh_point_stats(m: MapState, kf_slots: jnp.ndarray,
                        slot_ok: jnp.ndarray, *, max_obs: int = 8,
                        scale_factor: float = 1.2,
                        n_levels: int = 8) -> MapState:
    """Recompute representative descriptor, mean viewing normal and
    scale-invariance depth range for every landmark observed by the given
    keyframes (reference MapPoint::ComputeDistinctiveDescriptors — min
    median Hamming over all observations, src/MapPoint.cc:448-523 — and
    UpdateNormalAndDepth, :545-662).

    kf_slots: (Kw,) keyframe slots whose observations to aggregate (the
    local-mapping window); slot_ok: (Kw,) validity mask. Up to `max_obs`
    observations per landmark participate in the descriptor vote.
    """
    Kw = kf_slots.shape[0]
    N = m.n_feat
    P = m.max_mp
    F = Kw * N

    flat_mp = jnp.where(slot_ok[:, None], m.kf_mp[kf_slots], NO_MP)
    flat_mp = jnp.where(m.kf_feat_valid[kf_slots], flat_mp, NO_MP).reshape(-1)
    flat_kf = jnp.repeat(kf_slots, N)
    flat_desc = m.kf_desc[kf_slots].reshape(F, 8)
    flat_level = m.kf_level[kf_slots].reshape(F)

    # viewing directions: landmark - camera center of the observing KF
    R = m.kf_pose[kf_slots, :3, :3]                     # (Kw, 3, 3)
    t = m.kf_pose[kf_slots, :3, 3]
    centers = -jnp.einsum("kji,kj->ki", R, t)           # (Kw, 3)
    flat_center = jnp.repeat(centers, N, axis=0)        # (F, 3)
    mp_safe = jnp.where(flat_mp >= 0, flat_mp, 0)
    view = m.mp_pos[mp_safe] - flat_center
    dist = jnp.linalg.norm(view, axis=-1) + 1e-8
    nrm = view / dist[:, None]

    valid = flat_mp >= 0
    key = jnp.where(valid, flat_mp, P)

    # --- normals: masked segment mean over ALL window observations ---
    w = valid.astype(jnp.float32)
    nsum = jnp.zeros((P + 1, 3), jnp.float32).at[key].add(nrm * w[:, None])
    cnt = jnp.zeros((P + 1,), jnp.float32).at[key].add(w)
    touched = cnt[:P] > 0
    new_normal = nsum[:P] / jnp.maximum(cnt[:P, None], 1.0)
    new_normal = new_normal / (
        jnp.linalg.norm(new_normal, axis=-1, keepdims=True) + 1e-8)

    # --- depth range: reference uses the reference-KF observation only ---
    is_ref = valid & (flat_kf == m.mp_ref_kf[mp_safe])
    ref_key = jnp.where(is_ref, flat_mp, P)
    ref_dist = jnp.zeros((P + 1,), jnp.float32).at[ref_key].max(
        jnp.where(is_ref, dist, 0.0))
    ref_level = jnp.zeros((P + 1,), jnp.int32).at[ref_key].max(
        jnp.where(is_ref, flat_level, 0))
    has_ref = ref_dist[:P] > 0
    level_sf = jnp.power(jnp.float32(scale_factor),
                         ref_level[:P].astype(jnp.float32))
    max_d = ref_dist[:P] * level_sf
    min_d = max_d / jnp.float32(scale_factor ** (n_levels - 1))

    # --- representative descriptor: min-median Hamming over <= max_obs ---
    # rank of each observation within its landmark's group (sort by slot)
    order = jnp.argsort(key)
    skey = key[order]
    pos = jnp.arange(F, dtype=jnp.int32)
    group_start = jnp.where(
        skey != jnp.concatenate([jnp.full((1,), -2, skey.dtype), skey[:-1]]),
        pos, 0)
    group_start = jax.lax.cummax(group_start)
    rank = pos - group_start
    # observation table: (P+1, max_obs) -> flat obs index (F = absent)
    in_tab = (skey < P) & (rank < max_obs)
    tab = jnp.full((P + 1, max_obs), F, jnp.int32).at[
        jnp.where(in_tab, skey, P),
        jnp.where(in_tab, rank, 0)].set(
        jnp.where(in_tab, order[pos], F))[:P]
    tab_ok = tab < F
    desc_ext = jnp.concatenate(
        [flat_desc, jnp.zeros((1, 8), jnp.uint32)], axis=0)
    D = desc_ext[jnp.where(tab_ok, tab, F)]             # (P, O, 8)
    x = jnp.bitwise_xor(D[:, :, None, :], D[:, None, :, :])
    ham = jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)
    BIGD = jnp.int32(1 << 20)
    pair_ok = tab_ok[:, :, None] & tab_ok[:, None, :]
    ham = jnp.where(pair_ok, ham, BIGD)
    ham_sorted = jnp.sort(ham, axis=-1)                 # (P, O, O)
    n_obs = jnp.sum(tab_ok, axis=-1)                    # (P,)
    med_idx = jnp.maximum(n_obs - 1, 0) // 2            # reference: 0.5*(n-1)
    med = jnp.take_along_axis(
        ham_sorted, med_idx[:, None, None].repeat(max_obs, axis=1), axis=-1
    )[..., 0]                                           # (P, O)
    med = jnp.where(tab_ok, med, BIGD)
    best_obs = jnp.argmin(med, axis=-1)                 # (P,)
    best_desc = jnp.take_along_axis(
        D, best_obs[:, None, None].repeat(8, axis=-1), axis=1)[:, 0]

    upd_desc = touched & (n_obs > 0)
    return m._replace(
        mp_desc=jnp.where(upd_desc[:, None], best_desc, m.mp_desc),
        mp_normal=jnp.where(touched[:, None], new_normal, m.mp_normal),
        mp_min_dist=jnp.where(touched & has_ref, min_d, m.mp_min_dist),
        mp_max_dist=jnp.where(touched & has_ref, max_d, m.mp_max_dist),
    )


@functools.partial(jax.jit, donate_argnums=0)
def replace_mappoint(m: MapState, old: jnp.ndarray, new: jnp.ndarray) -> MapState:
    """Fuse duplicates: all references to `old` become `new` (reference
    MapPoint::Replace, src/MapPoint.cc:367). old/new: (B,) slot arrays."""
    ok = (old >= 0) & (new >= 0)
    old_safe = jnp.where(ok, old, m.max_mp)
    lut = jnp.arange(m.max_mp + 1, dtype=jnp.int32)
    lut = lut.at[old_safe].set(jnp.where(ok, new, lut[old_safe]))
    point = jnp.where(m.kf_mp >= 0, m.kf_mp, m.max_mp)
    remapped = lut[point]
    kf_mp = jnp.where(m.kf_mp >= 0, jnp.where(remapped == m.max_mp, NO_MP,
                                              remapped), NO_MP)
    mp_valid = m.mp_valid.at[jnp.where(ok, old, 0)].set(
        jnp.where(ok, False, m.mp_valid[jnp.where(ok, old, 0)]))
    found = m.mp_found.at[jnp.where(ok, new, 0)].add(
        jnp.where(ok, m.mp_found[jnp.where(ok, old, 0)], 0))
    redirect = m.mp_redirect.at[jnp.where(ok, old, 0)].set(
        jnp.where(ok, new, m.mp_redirect[jnp.where(ok, old, 0)]))
    return m._replace(kf_mp=kf_mp, mp_valid=mp_valid, mp_found=found,
                      mp_redirect=redirect)


# ----------------------------------------------------------------------
# Client-side Atlas (multi sub-map) operations. Replaces the reference's
# Atlas multi-map container (src/Atlas.cc: CreateNewMap :43, ChangeMap
# :92) and Tracking::CreateMapInAtlas (src/Tracking.cc:2400): sub-maps
# share the one arena and are separated by kf_map_id/mp_map_id; the
# active map gates tracking and mapping.
# ----------------------------------------------------------------------

@jax.jit
def switch_map(m: MapState, map_id) -> MapState:
    """Change the active sub-map (Atlas::ChangeMap analog)."""
    return m._replace(active_map=jnp.int32(map_id))


@jax.jit
def erase_active_map(m: MapState) -> MapState:
    """Tombstone every entity of the active sub-map (the reference's
    Tracking::ResetActiveMap, src/Tracking.cc:3588 — used when tracking
    is lost before the map matured)."""
    kf_gone = m.kf_valid & (m.kf_map_id == m.active_map)
    mp_gone = m.mp_valid & (m.mp_map_id == m.active_map)
    kf_mp = jnp.where(kf_gone[:, None], NO_MP, m.kf_mp)
    # also detach surviving KFs' references to erased landmarks
    point = jnp.where(kf_mp >= 0, kf_mp, 0)
    kf_mp = jnp.where((kf_mp >= 0) & mp_gone[point], NO_MP, kf_mp)
    return m._replace(
        kf_valid=m.kf_valid & ~kf_gone,
        mp_valid=m.mp_valid & ~mp_gone,
        kf_mp=kf_mp)


@jax.jit
def merge_active_into(m: MapState, target_map, S_loop) -> MapState:
    """Weld the active sub-map into `target_map` (the client-side Atlas
    merge; the reference's LoopClosing::MergeLocal moves all KFs/MPs of
    the current map into the merge map, src/LoopClosing.cc:1316).

    S_loop: sim3.Sim3 with p_cur ~ S_loop(p_target) — moved entities are
    pulled through S_loop^-1 into the target frame, ids are relabeled and
    the target becomes active.
    """
    from multi_orbslam3_jax.geometry import se3 as _se3
    from multi_orbslam3_jax.geometry import sim3 as _sim3
    move_kf = m.kf_map_id == m.active_map
    move_mp = m.mp_map_id == m.active_map
    S_inv = _sim3.inverse(S_loop)
    new_pos = _sim3.apply(S_inv, m.mp_pos)
    mp_pos = jnp.where(move_mp[:, None], new_pos, m.mp_pos)
    S_cw = _sim3.from_se3(m.kf_pose)
    S_new = _sim3.compose(S_cw, S_loop)
    T_new = _se3.make(S_new.R, S_new.t / S_new.s[..., None])
    kf_pose = jnp.where(move_kf[:, None, None], T_new, m.kf_pose)
    return m._replace(
        kf_pose=kf_pose, mp_pos=mp_pos,
        kf_map_id=jnp.where(move_kf, jnp.int32(target_map), m.kf_map_id),
        mp_map_id=jnp.where(move_mp, jnp.int32(target_map), m.mp_map_id),
        active_map=jnp.int32(target_map))
