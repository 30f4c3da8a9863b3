// mo3 wire codec: flat array-table serialization for MapDelta payloads.
//
// Replacement for the reference's ROS message serialization
// (hand-written field-by-field packing in the ConvertToMessage methods,
// reference src/Communicator.cc + msg/*.msg). The collaborative layer
// ships struct-of-arrays deltas, so the natural wire format is a table
// of named nd-arrays packed contiguously:
//
//   header:  magic "MO3C" | u8 version | u8 flags | u16 n_arrays
//            | u32 meta_len | u32 crc32 (of everything after the header)
//   meta:    meta_len bytes (JSON, envelope scalars)
//   entry*:  u8 name_len | name | u8 dtype | u8 ndim | i64 shape[ndim]
//            | u64 data_len | pad to 8-byte alignment | data bytes
//
// Decode is zero-copy: the unpacker returns offsets into the buffer and
// the Python side builds numpy views. CRC32 (polynomial 0xEDB88320,
// slice-by-8) guards the transport path — a truncated or corrupted frame
// is rejected before any state is touched (the message-loss hardening
// story: the client outbox resends unacked deltas, so a dropped frame
// costs one resend cycle, never a corrupted map).
//
// Build: multi_orbslam3_jax/collab/codec.py compiles this file on first
// use into native/libmo3codec-<source hash>.so and binds it with ctypes;
// it also carries a pure-Python fallback implementing the identical
// format.

#include <zlib.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr uint8_t kVersion = 1;
constexpr char kMagic[4] = {'M', 'O', '3', 'C'};
constexpr uint64_t kHeaderSize = 4 + 1 + 1 + 2 + 4 + 4;
constexpr uint32_t kMaxDims = 8;

// CRC32 (IEEE 0xEDB88320) via zlib — hardware-accelerated (PCLMUL
// folding) and bit-identical to Python's zlib.crc32, which the
// pure-Python twin uses.
uint32_t crc32_update(uint32_t crc, const uint8_t* p, uint64_t n) {
  return static_cast<uint32_t>(
      crc32_z(static_cast<uLong>(crc), p, static_cast<z_size_t>(n)));
}

uint64_t align8(uint64_t x) { return (x + 7) & ~uint64_t(7); }

uint64_t entry_size(uint8_t name_len, uint8_t ndim, uint64_t data_len) {
  uint64_t hdr = 1 + name_len + 1 + 1 + uint64_t(8) * ndim + 8;
  return align8(hdr) + align8(data_len);
}

void put_u16(uint8_t* p, uint16_t v) { std::memcpy(p, &v, 2); }
void put_u32(uint8_t* p, uint32_t v) { std::memcpy(p, &v, 4); }
void put_u64(uint8_t* p, uint64_t v) { std::memcpy(p, &v, 8); }
void put_i64(uint8_t* p, int64_t v) { std::memcpy(p, &v, 8); }
uint16_t get_u16(const uint8_t* p) { uint16_t v; std::memcpy(&v, p, 2); return v; }
uint32_t get_u32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
uint64_t get_u64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }
int64_t get_i64(const uint8_t* p) { int64_t v; std::memcpy(&v, p, 8); return v; }

}  // namespace

extern "C" {

// Bytes needed to pack the given table (for single-allocation assembly).
uint64_t mo3_pack_size(uint32_t meta_len, uint32_t n,
                       const uint8_t* name_lens, const uint8_t* ndims,
                       const uint64_t* nbytes) {
  uint64_t total = kHeaderSize + align8(meta_len);
  for (uint32_t i = 0; i < n; ++i)
    total += entry_size(name_lens[i], ndims[i], nbytes[i]);
  return total;
}

// Pack the table into out (capacity cap). names: concatenated name bytes
// (lengths in name_lens). shapes: flat i64[n * kMaxDims]. Returns bytes
// written, or -1 if the buffer is too small / inputs invalid.
int64_t mo3_pack(uint8_t* out, uint64_t cap, const uint8_t* meta,
                 uint32_t meta_len, uint32_t n, const uint8_t* names,
                 const uint8_t* name_lens, const uint8_t* dtypes,
                 const uint8_t* ndims, const int64_t* shapes,
                 const void* const* datas, const uint64_t* nbytes) {
  if (n > 0xFFFF) return -1;
  uint64_t need = mo3_pack_size(meta_len, n, name_lens, ndims, nbytes);
  if (need > cap) return -1;
  uint8_t* p = out;
  std::memcpy(p, kMagic, 4);
  p[4] = kVersion;
  p[5] = 0;  // flags
  put_u16(p + 6, static_cast<uint16_t>(n));
  put_u32(p + 8, meta_len);
  // crc written last (p + 12)
  p += kHeaderSize;
  std::memcpy(p, meta, meta_len);
  std::memset(p + meta_len, 0, align8(meta_len) - meta_len);
  p += align8(meta_len);
  const uint8_t* name_p = names;
  for (uint32_t i = 0; i < n; ++i) {
    if (ndims[i] > kMaxDims) return -1;
    uint8_t* e = p;
    *e++ = name_lens[i];
    std::memcpy(e, name_p, name_lens[i]);
    e += name_lens[i];
    name_p += name_lens[i];
    *e++ = dtypes[i];
    *e++ = ndims[i];
    for (uint32_t d = 0; d < ndims[i]; ++d, e += 8)
      put_i64(e, shapes[i * kMaxDims + d]);
    put_u64(e, nbytes[i]);
    e += 8;
    uint64_t hdr = static_cast<uint64_t>(e - p);
    std::memset(e, 0, align8(hdr) - hdr);
    p += align8(hdr);
    std::memcpy(p, datas[i], nbytes[i]);
    std::memset(p + nbytes[i], 0, align8(nbytes[i]) - nbytes[i]);
    p += align8(nbytes[i]);
  }
  uint64_t written = static_cast<uint64_t>(p - out);
  put_u32(out + 12, crc32_update(0, out + kHeaderSize, written - kHeaderSize));
  return static_cast<int64_t>(written);
}

// Validate the frame and return n_arrays (>=0), or a negative error:
// -1 bad magic/version/size, -2 CRC mismatch.
int32_t mo3_probe(const uint8_t* buf, uint64_t len, uint32_t* meta_off,
                  uint32_t* meta_len) {
  if (len < kHeaderSize || std::memcmp(buf, kMagic, 4) != 0 ||
      buf[4] != kVersion)
    return -1;
  uint32_t ml = get_u32(buf + 8);
  if (kHeaderSize + align8(ml) > len) return -1;
  if (get_u32(buf + 12) != crc32_update(0, buf + kHeaderSize, len - kHeaderSize))
    return -2;
  *meta_off = static_cast<uint32_t>(kHeaderSize);
  *meta_len = ml;
  return static_cast<int32_t>(get_u16(buf + 6));
}

// Fill per-array descriptors (call with max_n >= mo3_probe(...) result).
// names_out: max_n * 64 bytes (NUL padded). shapes_out: max_n * kMaxDims.
// offsets are byte offsets of array data within buf. Returns number of
// arrays decoded, or -1 on malformed entries.
int32_t mo3_unpack(const uint8_t* buf, uint64_t len, uint32_t max_n,
                   uint8_t* names_out, uint8_t* dtypes_out,
                   uint8_t* ndims_out, int64_t* shapes_out,
                   uint64_t* offsets_out, uint64_t* nbytes_out) {
  if (len < kHeaderSize) return -1;
  uint32_t n = get_u16(buf + 6);
  if (n > max_n) return -1;
  uint64_t pos = kHeaderSize + align8(get_u32(buf + 8));
  for (uint32_t i = 0; i < n; ++i) {
    if (pos + 1 > len) return -1;
    const uint8_t* e = buf + pos;
    uint8_t name_len = *e++;
    uint64_t hdr_need = uint64_t(1) + name_len + 2;
    if (pos + hdr_need > len || name_len > 63) return -1;
    std::memset(names_out + uint64_t(i) * 64, 0, 64);
    std::memcpy(names_out + uint64_t(i) * 64, e, name_len);
    e += name_len;
    dtypes_out[i] = *e++;
    uint8_t nd = *e++;
    if (nd > kMaxDims) return -1;
    ndims_out[i] = nd;
    if (pos + hdr_need + uint64_t(8) * nd + 8 > len) return -1;
    for (uint32_t d = 0; d < kMaxDims; ++d)
      shapes_out[uint64_t(i) * kMaxDims + d] =
          d < nd ? get_i64(e + uint64_t(8) * d) : 0;
    e += uint64_t(8) * nd;
    uint64_t nb = get_u64(e);
    e += 8;
    uint64_t hdr = static_cast<uint64_t>(e - (buf + pos));
    pos += align8(hdr);
    if (pos + nb > len) return -1;
    offsets_out[i] = pos;
    nbytes_out[i] = nb;
    pos += align8(nb);
  }
  return static_cast<int32_t>(n);
}

// Standalone CRC32 (exposed for transport-level framing checks).
uint32_t mo3_crc32(const uint8_t* p, uint64_t n) {
  return crc32_update(0, p, n);
}

}  // extern "C"
