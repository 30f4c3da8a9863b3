"""Wire codec for MapDelta payloads: named nd-array table + JSON meta.

The native C++ implementation (native/mo3_codec.cpp, compiled on first
use to native/libmo3codec-<source hash>.so) does single-allocation
packing and zero-copy unpacking with CRC32 integrity — the analog of
the reference's hand-written ROS message serialization
(ConvertToMessage* methods, reference src/Communicator.cc + msg/*.msg).
A pure-Python implementation of the IDENTICAL format backs it up, so
mixed deployments (one side without a compiler) interoperate.

Format (little-endian):
  header:  b"MO3C" | u8 version | u8 flags | u16 n_arrays
           | u32 meta_len | u32 crc32(everything after the header)
  meta:    meta_len JSON bytes, zero-padded to 8
  entry*:  u8 name_len | name | u8 dtype | u8 ndim | i64 shape[ndim]
           | u64 data_len | pad8 | data | pad8

API: ``pack(meta: dict, arrays: dict[str, ndarray]) -> bytes`` and
``unpack(bytes) -> (meta, arrays)``; unpack raises ValueError on a
corrupted/truncated frame (CRC), so transports drop bad frames cleanly
and the client outbox resend covers the loss.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import struct
import subprocess
import threading
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

_MAGIC = b"MO3C"
_VERSION = 1
_HDR = struct.Struct("<4sBBHII")   # magic, ver, flags, n, meta_len, crc
_MAXD = 8

# dtype code table (fixed on the wire)
_DTYPES = [np.dtype(np.float32), np.dtype(np.float64), np.dtype(np.int32),
           np.dtype(np.int64), np.dtype(np.uint32), np.dtype(np.uint8),
           np.dtype(np.bool_), np.dtype(np.uint16), np.dtype(np.int16),
           np.dtype(np.uint64), np.dtype(np.int8), np.dtype(np.float16)]
_DTYPE_CODE = {dt: i for i, dt in enumerate(_DTYPES)}


def _align8(x: int) -> int:
    return (x + 7) & ~7


_EMPTY = ctypes.create_string_buffer(1)   # stable pointer for 0-size arrays


# ---------------------------------------------------------------------------
# Native library loading (auto-build on first use when possible).
# ---------------------------------------------------------------------------
_lib = None
_lib_lock = threading.Lock()
_lib_tried = False


def _native_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "native")


def _load_native() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    with _lib_lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        if os.environ.get("MO3_NO_NATIVE"):
            return None
        src = os.path.join(_native_dir(), "mo3_codec.cpp")
        try:
            with open(src, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()[:12]
        except OSError:
            return None
        # keyed by the source's hash: a library built from another
        # version of the source is never loaded
        so = os.path.join(_native_dir(), f"libmo3codec-{digest}.so")
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            try:
                subprocess.run(
                    ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                     "-o", tmp, src, "-lz"],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)     # atomic against concurrent builds
            except (OSError, subprocess.SubprocessError):
                return None             # no compiler: use the fallback
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.mo3_pack_size.restype = ctypes.c_uint64
        lib.mo3_pack_size.argtypes = [
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64)]
        lib.mo3_pack.restype = ctypes.c_int64
        lib.mo3_pack.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.mo3_probe.restype = ctypes.c_int32
        lib.mo3_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32)]
        lib.mo3_unpack.restype = ctypes.c_int32
        lib.mo3_unpack.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64)]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_native() is not None


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------
def _json_default(o):
    if isinstance(o, np.generic):      # numpy scalar leaked into meta
        return o.item()
    raise TypeError(f"meta value not JSON-serializable: {type(o)}")


def pack(meta: Dict, arrays: Dict[str, np.ndarray]) -> bytes:
    meta_b = json.dumps(meta, separators=(",", ":"),
                        default=_json_default).encode()
    items = []
    for name, a in arrays.items():
        a = np.ascontiguousarray(a)
        if a.dtype not in _DTYPE_CODE:
            a = np.ascontiguousarray(a.astype(np.float64))
        items.append((name.encode(), a))
    lib = _load_native()
    if lib is not None:
        return _pack_native(lib, meta_b, items)
    return _pack_py(meta_b, items)


def unpack(data: bytes) -> Tuple[Dict, Dict[str, np.ndarray]]:
    lib = _load_native()
    if lib is not None:
        return _unpack_native(lib, data)
    return _unpack_py(data)


def peek_meta(data: bytes) -> Dict:
    """CRC-validate the frame and return ONLY the meta dict — O(header +
    crc) instead of materializing the array table (used by receivers to
    read the envelope seq before deciding to buffer/drop/ingest)."""
    lib = _load_native()
    if lib is not None:
        meta_off = ctypes.c_uint32()
        meta_len = ctypes.c_uint32()
        n = lib.mo3_probe(data, len(data), ctypes.byref(meta_off),
                          ctypes.byref(meta_len))
        if n == -2:
            raise ValueError("mo3 frame CRC mismatch")
        if n < 0:
            raise ValueError("not an mo3 frame")
        return json.loads(
            data[meta_off.value:meta_off.value + meta_len.value].decode())
    if len(data) < _HDR.size or data[:4] != _MAGIC:
        raise ValueError("not an mo3 frame")
    _, ver, _f, _n, meta_len, crc = _HDR.unpack_from(data)
    if ver != _VERSION:
        raise ValueError("mo3 version mismatch")
    if zlib.crc32(data[_HDR.size:]) & 0xFFFFFFFF != crc:
        raise ValueError("mo3 frame CRC mismatch")
    return json.loads(data[_HDR.size:_HDR.size + meta_len].decode())


# ---------------------------------------------------------------------------
def _pack_native(lib, meta_b: bytes, items) -> bytes:
    n = len(items)
    names = b"".join(nm for nm, _ in items)
    name_lens = bytes(len(nm) for nm, _ in items)
    dtypes = bytes(_DTYPE_CODE[a.dtype] for _, a in items)
    ndims = bytes(a.ndim for _, a in items)
    shapes = (ctypes.c_int64 * (n * _MAXD))()
    datas = (ctypes.c_void_p * max(n, 1))()
    nbytes = (ctypes.c_uint64 * max(n, 1))()
    keep = []
    for i, (_, a) in enumerate(items):
        for d, s in enumerate(a.shape):
            shapes[i * _MAXD + d] = s
        keep.append(a)   # keep buffers alive across the C call
        datas[i] = a.ctypes.data if a.size else ctypes.addressof(_EMPTY)
        nbytes[i] = a.nbytes
    size = lib.mo3_pack_size(len(meta_b), n, name_lens, ndims, nbytes)
    out = bytearray(size)
    written = lib.mo3_pack((ctypes.c_char * size).from_buffer(out), size,
                           meta_b, len(meta_b), n, names, name_lens,
                           dtypes, ndims, shapes, datas, nbytes)
    if written != size:
        raise ValueError("mo3_pack failed")
    return bytes(out)


def _unpack_native(lib, data: bytes) -> Tuple[Dict, Dict[str, np.ndarray]]:
    meta_off = ctypes.c_uint32()
    meta_len = ctypes.c_uint32()
    n = lib.mo3_probe(data, len(data), ctypes.byref(meta_off),
                      ctypes.byref(meta_len))
    if n == -2:
        raise ValueError("mo3 frame CRC mismatch")
    if n < 0:
        raise ValueError("not an mo3 frame")
    names = ctypes.create_string_buffer(max(n, 1) * 64)
    dtypes = ctypes.create_string_buffer(max(n, 1))
    ndims = ctypes.create_string_buffer(max(n, 1))
    shapes = (ctypes.c_int64 * (max(n, 1) * _MAXD))()
    offsets = (ctypes.c_uint64 * max(n, 1))()
    nbytes = (ctypes.c_uint64 * max(n, 1))()
    got = lib.mo3_unpack(data, len(data), n, names, dtypes, ndims,
                         shapes, offsets, nbytes)
    if got != n:
        raise ValueError("malformed mo3 frame")
    meta = json.loads(
        data[meta_off.value:meta_off.value + meta_len.value].decode())
    arrays: Dict[str, np.ndarray] = {}
    for i in range(n):
        name = names.raw[i * 64:(i + 1) * 64].rstrip(b"\0").decode()
        dt = _DTYPES[dtypes.raw[i]]
        nd = ndims.raw[i]
        shape = tuple(shapes[i * _MAXD + d] for d in range(nd))
        count = int(np.prod(shape)) if nd else 1
        arrays[name] = np.frombuffer(
            data, dtype=dt, count=count, offset=offsets[i]).reshape(shape)
    return meta, arrays


# ---------------------------------------------------------------------------
# Pure-Python fallback (identical wire format).
# ---------------------------------------------------------------------------
def _pack_py(meta_b: bytes, items) -> bytes:
    parts = [meta_b, b"\0" * (_align8(len(meta_b)) - len(meta_b))]
    for nm, a in items:
        ehdr = struct.pack("<B", len(nm)) + nm + struct.pack(
            "<BB", _DTYPE_CODE[a.dtype], a.ndim)
        ehdr += b"".join(struct.pack("<q", s) for s in a.shape)
        ehdr += struct.pack("<Q", a.nbytes)
        ehdr += b"\0" * (_align8(len(ehdr)) - len(ehdr))
        raw = a.tobytes()
        parts.append(ehdr)
        parts.append(raw + b"\0" * (_align8(len(raw)) - len(raw)))
    body = b"".join(parts)
    crc = zlib.crc32(body) & 0xFFFFFFFF
    return _HDR.pack(_MAGIC, _VERSION, 0, len(items), len(meta_b),
                     crc) + body


def _unpack_py(data: bytes) -> Tuple[Dict, Dict[str, np.ndarray]]:
    if len(data) < _HDR.size or data[:4] != _MAGIC:
        raise ValueError("not an mo3 frame")
    magic, ver, _flags, n, meta_len, crc = _HDR.unpack_from(data)
    if ver != _VERSION:
        raise ValueError("mo3 version mismatch")
    if zlib.crc32(data[_HDR.size:]) & 0xFFFFFFFF != crc:
        raise ValueError("mo3 frame CRC mismatch")
    pos = _HDR.size
    meta = json.loads(data[pos:pos + meta_len].decode())
    pos += _align8(meta_len)
    arrays: Dict[str, np.ndarray] = {}
    for _ in range(n):
        name_len = data[pos]
        name = data[pos + 1:pos + 1 + name_len].decode()
        o = pos + 1 + name_len
        dt_code, nd = data[o], data[o + 1]
        o += 2
        shape = tuple(struct.unpack_from("<q", data, o + 8 * d)[0]
                      for d in range(nd))
        o += 8 * nd
        nbytes = struct.unpack_from("<Q", data, o)[0]
        o += 8
        pos += _align8(o - pos)
        dt = _DTYPES[dt_code]
        count = int(np.prod(shape)) if nd else 1
        arrays[name] = np.frombuffer(
            data, dtype=dt, count=count, offset=pos).reshape(shape)
        pos += _align8(nbytes)
    return meta, arrays
