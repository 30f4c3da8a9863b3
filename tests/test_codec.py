"""Wire codec: native C++ <-> pure-Python format conformance, CRC
integrity, and MapDelta round-trip through the new path."""

import json

import numpy as np
import pytest

from multi_orbslam3_jax.collab import codec, protocol


def _table():
    rng = np.random.RandomState(3)
    arrays = {
        "kfs.uv": rng.rand(5, 64, 2).astype(np.float32),
        "kfs.desc": rng.randint(0, 2 ** 32, (5, 64, 8)).astype(np.uint32),
        "kfs.feat_valid": rng.rand(5, 64) > 0.5,
        "mps.local_id": np.arange(100, dtype=np.int32),
        "empty": np.array([], dtype=np.int32),
        # 0-d arrays are normalized to shape (1,) by ascontiguousarray;
        # true scalars travel in meta, not the array table
        "scalarish": np.array([3.5]),
    }
    meta = {"agent": 1, "seq": 9, "scale": 1.5, "inertial": False,
            "kfs.agent": 1}
    return meta, arrays


def test_roundtrip_dispatch():
    meta, arrays = _table()
    m, a = codec.unpack(codec.pack(meta, arrays))
    assert m == meta
    for k, v in arrays.items():
        assert a[k].dtype == v.dtype
        assert np.array_equal(a[k], v)


def test_python_fallback_format_identical():
    """The pure-Python twin must produce byte-identical frames so mixed
    deployments (one side without a compiler) interoperate."""
    meta, arrays = _table()
    items = [(k.encode(), np.ascontiguousarray(v))
             for k, v in arrays.items()]
    mb = json.dumps(meta, separators=(",", ":")).encode()
    frame_py = codec._pack_py(mb, items)
    m, a = codec._unpack_py(frame_py)
    assert m == meta and all(np.array_equal(a[k], v)
                             for k, v in arrays.items())
    if codec.native_available():
        lib = codec._load_native()
        assert codec._pack_native(lib, mb, items) == frame_py
        m2, a2 = codec._unpack_native(lib, frame_py)
        assert m2 == meta
        for k, v in arrays.items():
            assert np.array_equal(a2[k], v)


def test_peek_meta():
    meta, arrays = _table()
    frame = codec.pack(meta, arrays)
    assert codec.peek_meta(frame) == meta
    bad = bytearray(frame)
    bad[-1] ^= 0x01
    import pytest as _pytest
    with _pytest.raises(ValueError):
        codec.peek_meta(bytes(bad))
    from multi_orbslam3_jax.collab import protocol
    d = protocol.MapDelta(agent=1, seq=42)
    assert protocol.peek_seq(d.to_bytes()) == 42
    with _pytest.raises(ValueError):
        protocol.peek_seq(b"PK\x03\x04 not a real zip")


def test_crc_rejects_corruption():
    meta, arrays = _table()
    frame = bytearray(codec.pack(meta, arrays))
    frame[len(frame) // 2] ^= 0x40
    with pytest.raises(ValueError, match="CRC"):
        codec.unpack(bytes(frame))
    with pytest.raises(ValueError, match="CRC"):
        codec._unpack_py(bytes(frame))
    with pytest.raises(ValueError):
        codec.unpack(b"garbage")


def test_mapdelta_roundtrip_mo3():
    rng = np.random.RandomState(0)
    B, N = 3, 32
    delta = protocol.MapDelta(
        agent=2, seq=5,
        kfs=protocol.KFPayload(
            agent=2, local_id=np.arange(B, dtype=np.int32),
            timestamp=rng.rand(B),
            ref_ids=np.full((B, 3), -1, np.int32),
            T_rel=rng.rand(B, 3, 4, 4).astype(np.float32),
            T_abs=rng.rand(B, 4, 4).astype(np.float32),
            is_first=np.array([True, False, False]),
            uv=rng.rand(B, N, 2).astype(np.float32),
            desc=rng.randint(0, 2 ** 32, (B, N, 8)).astype(np.uint32),
            level=rng.randint(0, 8, (B, N)).astype(np.int32),
            angle=rng.rand(B, N).astype(np.float32),
            feat_valid=rng.rand(B, N) > 0.3,
            mp_local=rng.randint(-1, 50, (B, N)).astype(np.int32)),
        erased_kf=np.array([7, 9], np.int32),
        closest_kf=2, scale=1.25, R_gw=np.eye(3, dtype=np.float32),
        inertial=True, ack_seq=4)
    data = delta.to_bytes()
    assert data[:4] == b"MO3C"
    back = protocol.MapDelta.from_bytes(data)
    assert back.agent == 2 and back.seq == 5 and back.ack_seq == 4
    assert back.inertial and back.scale == 1.25 and back.closest_kf == 2
    assert np.array_equal(back.erased_kf, delta.erased_kf)
    assert np.allclose(back.R_gw, np.eye(3))
    for f in ("local_id", "T_rel", "T_abs", "uv", "desc", "level",
              "angle", "feat_valid", "mp_local", "ref_ids", "is_first"):
        assert np.array_equal(getattr(back.kfs, f), getattr(delta.kfs, f)), f
    assert back.kfs.agent == 2
    assert back.mps is None and back.kf_updates is None
