// jpeg_tpu native runtime: threaded LUT-based entropy decode + scan utilities.
//
// Native replacement for the runtime role the reference implements in
// Rust (HuffmanDecoder, src/jpeg/huffman.rs:109-268, and the MCU interleave
// loop, src/jpeg/decoder.rs:195-215): the irregular, bit-granular work stays
// on host but becomes O(1)-per-symbol via flat 16-bit LUTs and parallel
// across restart segments via a thread pool. The dense coefficient->pixel
// math lives on the device (jpeg_tpu.ops); this library only produces the
// [total_blocks, 64] coefficient tensor the device pipeline consumes.
//
// Hot-loop design: 64-bit left-aligned bit buffer with branch-predicted
// 8-byte bswap refill (libjpeg-turbo style), one packed (value<<8|length)
// uint16 LUT load per symbol. Tail reads past end-of-segment supply 0xAA
// fill bytes — bit-exact parity with the reference's padding
// (src/jpeg/huffman.rs:240-250).
//
// Build: see build.py / Makefile (g++ -O3 -shared). C ABI, driven via ctypes.

#include <immintrin.h>

#include <algorithm>
#include <array>
#include <atomic>
#include <cstdint>
#include <unistd.h>

#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int kLutBits = 16;
constexpr int64_t kLutSize = (int64_t)1 << kLutBits;

// JPEG Table F.2 sign extension (reference src/jpeg/huffman.rs:256-268).
inline int32_t value_correction(uint32_t v, int nbits) {
  if (nbits == 0) return 0;
  int32_t base = 1 << (nbits - 1);
  int32_t val = (int32_t)v;
  return (val < base) ? val - 2 * base + 1 : val;
}


// Two-level lookup: a 10-bit primary table (2KB, L1-resident) resolves the
// overwhelming majority of symbols; rare longer codes fall through to the
// full 2^16 table (sentinel length 0x1F). Entry packing matches the full
// table: (value << 8) | length.
constexpr int kL1Bits = 10;
constexpr int64_t kL1Size = (int64_t)1 << kL1Bits;
constexpr uint16_t kL1Miss = 0x1F;

struct TwoLevelLut {
  uint16_t primary[kL1Size];
  const uint16_t* full;

  void build(const uint16_t* full_lut) {
    full = full_lut;
    for (int64_t i = 0; i < kL1Size; ++i) {
      uint16_t e = full_lut[i << (kLutBits - kL1Bits)];
      primary[i] = ((e & 0xFF) <= kL1Bits) ? e : kL1Miss;
    }
  }
  inline uint32_t lookup(uint32_t peek16) const {
    uint32_t e = primary[peek16 >> (kLutBits - kL1Bits)];
    if (__builtin_expect((e & 0xFF) == kL1Miss, 0)) e = full[peek16];
    return e;
  }
};

// Value-fused fast table: a kFastBits-bit key resolves code AND magnitude
// bits in one lookup when code_len + size <= kFastBits (the overwhelming
// majority of DC symbols at typical qualities).
// Entry: [31:30] kind (0=coef, 1=EOB, 2=ZRL, 3=miss) | [29:25] total bits |
// [24:21] run | [15:0] value (int16). Entry 0xC0000000 (kind=3) = miss.
// Size choice: 10 bits = 4KB/table. The 12-bit variant (16KB/table) hit
// ~1% more DC codes but, together with the pair tables, pushed the hot
// table footprint past the 48KB L1d (A/B: tools/profile_entropy.cpp).
#ifndef JT_FAST_BITS
#define JT_FAST_BITS 10
#endif
constexpr int kFastBits = JT_FAST_BITS;
constexpr int64_t kFastSize = (int64_t)1 << kFastBits;
constexpr uint32_t kFastMiss = 0xC0000000u;

struct FastLut {
  uint32_t tab[kFastSize];

  // `is_dc`: DC entries decode (size, delta) pairs; AC entries decode
  // (run/size, value) pairs plus EOB/ZRL.
  void build(const uint16_t* full_lut, bool is_dc) {
    for (int64_t key = 0; key < kFastSize; ++key) {
      uint32_t peek = (uint32_t)(key << (kLutBits - kFastBits));
      uint32_t e = full_lut[peek];
      int len = e & 0xFF;
      int sym = e >> 8;
      tab[key] = kFastMiss;
      if (len == 0 || len > kFastBits) continue;
      if (!is_dc && sym == 0x00) {
        tab[key] = (1u << 30) | ((uint32_t)len << 25);
        continue;
      }
      if (!is_dc && sym == 0xF0) {
        tab[key] = (2u << 30) | ((uint32_t)len << 25);
        continue;
      }
      int run = is_dc ? 0 : ((sym >> 4) & 0xF);
      int size = is_dc ? sym : (sym & 0xF);
      int total = len + size;
      if (total > kFastBits) continue;
      uint32_t raw =
          ((uint32_t)key >> (kFastBits - total)) & ((1u << size) - 1);
      int32_t v = value_correction(raw, size);
      tab[key] = ((uint32_t)total << 25) | ((uint32_t)run << 21) |
                 ((uint32_t)(uint16_t)(int16_t)v);
    }
  }
};

// Pair-symbol AC table (libdeflate-style): one 12-bit lookup resolves up to
// TWO complete AC items — (code+magnitude, code+magnitude) or
// (code+magnitude, EOB) — when they fit the window together. Typical scans
// spend most symbols on short codes with 1-3 magnitude bits, so fusing
// halves the serially-dependent lookup chain; fusing the trailing EOB
// removes one more lookup per block. 2^12 x u64 = 32KB.
//
// Entry layout (u64):
//   [63:61] kind: 0 miss, 1 EOB, 2 ZRL, 3 single coef, 4 coef+coef,
//           5 coef+EOB
//   [60:56] total bits consumed (both items)
//   [55:51] bits for the first item alone (fallback when the second item
//           would cross a block boundary and belongs to the next block)
//   [50:46] adv1 = run1 + 1
//   [45:41] adv2 = run2 + 1
//   [31:16] val1 (int16)   [15:0] val2 (int16)
#ifndef JT_PAIR_BITS
#define JT_PAIR_BITS 12
#endif
constexpr int kPairBits = JT_PAIR_BITS;
constexpr int64_t kPairSize = (int64_t)1 << kPairBits;
constexpr int kPairShift = 64 - kPairBits;

struct PairLut {
  uint64_t tab[kPairSize];

  void build(const uint16_t* full_lut) {
    for (int64_t key = 0; key < kPairSize; ++key) {
      tab[key] = 0;  // miss
      uint32_t peek = (uint32_t)(key << (kLutBits - kPairBits));
      uint32_t e = full_lut[peek];
      int len1 = e & 0xFF;
      int sym1 = e >> 8;
      if (len1 == 0 || len1 > kPairBits) continue;
      if (sym1 == 0x00) {
        tab[key] = (1ull << 61) | ((uint64_t)len1 << 56);
        continue;
      }
      if (sym1 == 0xF0) {
        tab[key] = (2ull << 61) | ((uint64_t)len1 << 56);
        continue;
      }
      int run1 = (sym1 >> 4) & 0xF;
      int size1 = sym1 & 0xF;
      int total1 = len1 + size1;
      if (total1 > kPairBits) continue;  // magnitude crosses window: slow path
      uint32_t raw1 =
          ((uint32_t)key >> (kPairBits - total1)) & ((1u << size1) - 1);
      uint64_t val1 =
          (uint64_t)(uint16_t)(int16_t)value_correction(raw1, size1);
      uint64_t single = (3ull << 61) | ((uint64_t)total1 << 56) |
                        ((uint64_t)total1 << 51) |
                        ((uint64_t)(run1 + 1) << 46) | (val1 << 16);
      tab[key] = single;
      // Try to fuse a second item from the remaining window bits.
      int rem = kPairBits - total1;
      if (rem < 2) continue;
      uint32_t low = (uint32_t)key & ((1u << rem) - 1);
      uint32_t e2 = full_lut[low << (kLutBits - rem)];
      int len2 = e2 & 0xFF;
      int sym2 = e2 >> 8;
      if (len2 == 0 || len2 > rem) continue;
      if (sym2 == 0x00) {  // coef + EOB
        tab[key] = (5ull << 61) | ((uint64_t)(total1 + len2) << 56) |
                   ((uint64_t)total1 << 51) | ((uint64_t)(run1 + 1) << 46) |
                   (val1 << 16);
        continue;
      }
      if (sym2 == 0xF0) continue;  // coef + ZRL: rare, keep single
      int run2 = (sym2 >> 4) & 0xF;
      int size2 = sym2 & 0xF;
      int total2 = len2 + size2;
      if (total1 + total2 > kPairBits) continue;
      uint32_t raw2 = ((uint32_t)key >> (kPairBits - total1 - total2)) &
                      ((1u << size2) - 1);
      uint64_t val2 =
          (uint64_t)(uint16_t)(int16_t)value_correction(raw2, size2);
      tab[key] = (4ull << 61) | ((uint64_t)(total1 + total2) << 56) |
                 ((uint64_t)total1 << 51) | ((uint64_t)(run1 + 1) << 46) |
                 ((uint64_t)(run2 + 1) << 41) | (val1 << 16) | val2;
    }
  }
};

// Left-aligned 64-bit bit reader: top `count` bits of `bits` are valid.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t bits = 0;
  int count = 0;

  BitReader(const uint8_t* data, int64_t len) : p(data), end(data + len) {}

  inline void refill() {
    if (__builtin_expect(p + 8 <= end, 1)) {
      uint64_t w;
      std::memcpy(&w, p, 8);
      w = __builtin_bswap64(w);
      bits |= w >> count;
      int bytes = (63 - count) >> 3;
      p += bytes;
      count += bytes << 3;
    } else {
      while (count <= 56) {
        uint64_t b = (p < end) ? *p : 0xAA;  // reference 0xAA tail fill
        ++p;
        bits |= b << (56 - count);
        count += 8;
      }
    }
  }
  inline uint32_t peek16() {
    if (count < 16) refill();
    return (uint32_t)(bits >> 48);
  }
  inline void consume(int n) {
    bits <<= n;
    count -= n;
  }
  inline uint32_t read(int n) {
    if (n == 0) return 0;
    if (count < n) refill();
    uint32_t v = (uint32_t)(bits >> (64 - n));
    bits <<= n;
    count -= n;
    return v;
  }
};

// Decode one 64-coef block in zigzag order (DC as raw delta).
// Contract parity: reference next_block (src/jpeg/huffman.rs:146-195).
// Returns 0 ok, 1/2 invalid DC/AC prefix.
inline int next_block(BitReader& br, const TwoLevelLut& dc_lut,
                      const TwoLevelLut& ac_lut, const FastLut& dc_fast,
                      const PairLut& ac_pair, int32_t* out) {
  std::memset(out, 0, 64 * sizeof(int32_t));
  if (br.count < 31) br.refill();
  uint32_t f = dc_fast.tab[(uint32_t)(br.bits >> (64 - kFastBits))];
  if (__builtin_expect((f >> 30) == 0, 1)) {
    int tb = (f >> 25) & 31;
    br.bits <<= tb;
    br.count -= tb;
    out[0] = (int16_t)(uint16_t)f;
  } else {
    uint32_t e = dc_lut.lookup((uint32_t)(br.bits >> 48));
    int len = e & 0xFF;
    if (__builtin_expect(len == 0, 0)) return 1;
    br.consume(len);
    int nbits = e >> 8;
    out[0] = value_correction(br.read(nbits), nbits);
  }
  int k = 1;
  while (k < 64) {
    if (br.count < 31) br.refill();
    uint64_t fa = ac_pair.tab[(uint32_t)(br.bits >> kPairShift)];
    uint32_t kind = (uint32_t)(fa >> 61);
    if (__builtin_expect(kind >= 3, 1)) {
      int adv1 = (int)((fa >> 46) & 31);
      if (kind == 4) {  // two fused coefficients
        int adv2 = (int)((fa >> 41) & 31);
        if (__builtin_expect(k + adv1 + adv2 <= 64, 1)) {
          int tb = (int)((fa >> 56) & 31);
          br.bits <<= tb;
          br.count -= tb;
          k += adv1;
          out[k - 1] = (int16_t)(uint16_t)(fa >> 16);
          k += adv2;
          out[k - 1] = (int16_t)(uint16_t)fa;
          continue;
        }
      } else if (kind == 5) {  // coefficient + fused EOB
        // Strict <: a coefficient that fills the block to exactly 64 ends
        // it WITHOUT an EOB — the bits decoded as "EOB" at build time are
        // really the next block's DC code and must not be consumed.
        if (__builtin_expect(k + adv1 < 64, 1)) {
          int tb = (int)((fa >> 56) & 31);
          br.bits <<= tb;
          br.count -= tb;
          k += adv1;
          out[k - 1] = (int16_t)(uint16_t)(fa >> 16);
          return 0;
        }
      }
      // Single coefficient (kind 3, or a pair whose second item belongs
      // to the next block): consume only the first item's bits.
      int tb1 = (int)((fa >> 51) & 31);
      br.bits <<= tb1;
      br.count -= tb1;
      int run = adv1 - 1;
      int cap = 64 - k - 1;
      k += (run < cap) ? run : cap;
      out[k++] = (int16_t)(uint16_t)(fa >> 16);
      continue;
    }
    if (kind == 1) {  // EOB
      int tb = (int)((fa >> 56) & 31);
      br.bits <<= tb;
      br.count -= tb;
      break;
    }
    if (kind == 2) {  // ZRL
      int tb = (int)((fa >> 56) & 31);
      br.bits <<= tb;
      br.count -= tb;
      k += (64 - k < 16) ? (64 - k) : 16;
      continue;
    }
    uint32_t e = ac_lut.lookup((uint32_t)(br.bits >> 48));
    int len = e & 0xFF;
    if (__builtin_expect(len == 0, 0)) return 2;
    br.consume(len);
    int sym = e >> 8;
    if (sym == 0x00) break;  // EOB
    if (sym == 0xF0) {  // ZRL, capped at block end
      k += (64 - k < 16) ? (64 - k) : 16;
      continue;
    }
    int run = (sym >> 4) & 0xF;
    int size = sym & 0xF;
    int32_t v = value_correction(br.read(size), size);
    int cap = 64 - k - 1;
    k += (run < cap) ? run : cap;
    out[k++] = v;
  }
  return 0;
}

// Zigzag index -> (row, col) within an 8x8 block (JPEG spec scan order;
// same table as reference ZIGZAG_INDICES, src/jpeg/decoder.rs:404-407).
constexpr uint8_t kZigRow[64] = {
    0, 0, 1, 2, 1, 0, 0, 1, 2, 3, 4, 3, 2, 1, 0, 0, 1, 2, 3, 4, 5, 6,
    5, 4, 3, 2, 1, 0, 0, 1, 2, 3, 4, 5, 6, 7, 7, 6, 5, 4, 3, 2, 1, 2,
    3, 4, 5, 6, 7, 7, 6, 5, 4, 3, 4, 5, 6, 7, 7, 6, 5, 6, 7, 7};
constexpr uint8_t kZigCol[64] = {
    0, 1, 0, 0, 1, 2, 3, 2, 1, 0, 0, 1, 2, 3, 4, 5, 4, 3, 2, 1, 0, 0,
    1, 2, 3, 4, 5, 6, 7, 6, 5, 4, 3, 2, 1, 0, 1, 2, 3, 4, 5, 6, 7, 7,
    6, 5, 4, 3, 2, 3, 4, 5, 6, 7, 7, 6, 5, 4, 5, 6, 7, 7, 6, 7};

// Decode one block directly into a natural-order int16 component plane at
// (row0, col0): the de-zigzag "relayout" costs nothing extra here (the
// scatter writes happen anyway), which is what lets the device pixel stage
// read whole planes with no relayout (ops/pixel.py).
// DC symbol of one plane block: fast value-fused path, full-LUT
// fallback. Returns 0 ok, 1 invalid prefix. (Step helpers factored out
// of next_block_plane so the two-stream interleaved decoder below can
// run the identical state machine on two independent bit chains.)
inline int dc_step_plane(BitReader& br, const TwoLevelLut& dc_lut,
                         const FastLut& dc_fast, int16_t* plane,
                         int32_t* prev_dc) {
  // A symbol needs at most 16 (code) + 15 (magnitude, 12-bit DC) = 31
  // bits, so one refill up front covers code+magnitude below.
  if (br.count < 31) br.refill();
  int32_t dc;
  uint32_t f = dc_fast.tab[(uint32_t)(br.bits >> (64 - kFastBits))];
  if (__builtin_expect((f >> 30) == 0, 1)) {
    int tb = (f >> 25) & 31;
    br.bits <<= tb;
    br.count -= tb;
    dc = (int16_t)(uint16_t)f + *prev_dc;
  } else {
    uint32_t e = dc_lut.lookup((uint32_t)(br.bits >> 48));
    int len = e & 0xFF;
    if (__builtin_expect(len == 0, 0)) return 1;
    int nbits = e >> 8;
    int total = len + nbits;
    uint32_t raw = (uint32_t)((br.bits >> (64 - total)) & ((1u << nbits) - 1));
    br.bits <<= total;
    br.count -= total;
    dc = value_correction(raw, nbits) + *prev_dc;
  }
  *prev_dc = dc;
  plane[0] = (int16_t)dc;
  return 0;
}

// One AC pair-LUT step (up to two coefficients). Returns 0 = continue
// (caller re-checks k < 64), 1 = block finished (EOB), 2 = invalid
// prefix.
inline int ac_step_plane(BitReader& br, const TwoLevelLut& ac_lut,
                         const PairLut& ac_pair, int16_t* plane,
                         const int32_t* zoff, int& k) {
  if (br.count < 31) br.refill();
  uint64_t fa = ac_pair.tab[(uint32_t)(br.bits >> kPairShift)];
  uint32_t kind = (uint32_t)(fa >> 61);
  if (__builtin_expect(kind >= 3, 1)) {
    int adv1 = (int)((fa >> 46) & 31);
    if (kind == 4) {  // two fused coefficients
      int adv2 = (int)((fa >> 41) & 31);
      if (__builtin_expect(k + adv1 + adv2 <= 64, 1)) {
        int tb = (int)((fa >> 56) & 31);
        br.bits <<= tb;
        br.count -= tb;
        k += adv1;
        plane[zoff[k - 1]] = (int16_t)(uint16_t)(fa >> 16);
        k += adv2;
        plane[zoff[k - 1]] = (int16_t)(uint16_t)fa;
        return 0;
      }
    } else if (kind == 5) {  // coefficient + fused EOB
      // Strict <: a coefficient that fills the block to exactly 64 ends
      // it WITHOUT an EOB — the bits decoded as "EOB" at build time are
      // really the next block's DC code and must not be consumed.
      if (__builtin_expect(k + adv1 < 64, 1)) {
        int tb = (int)((fa >> 56) & 31);
        br.bits <<= tb;
        br.count -= tb;
        k += adv1;
        plane[zoff[k - 1]] = (int16_t)(uint16_t)(fa >> 16);
        return 1;
      }
    }
    // Single coefficient (kind 3, or pair split at a block boundary).
    int tb1 = (int)((fa >> 51) & 31);
    br.bits <<= tb1;
    br.count -= tb1;
    int run = adv1 - 1;
    int cap = 64 - k - 1;
    k += (run < cap) ? run : cap;
    plane[zoff[k++]] = (int16_t)(uint16_t)(fa >> 16);
    return 0;
  }
  if (kind == 1) {  // EOB
    int tb = (int)((fa >> 56) & 31);
    br.bits <<= tb;
    br.count -= tb;
    return 1;
  }
  if (kind == 2) {  // ZRL
    int tb = (int)((fa >> 56) & 31);
    br.bits <<= tb;
    br.count -= tb;
    k += (64 - k < 16) ? (64 - k) : 16;
    return 0;
  }
  // Miss: long code or large magnitude — full-path decode.
  uint32_t e = ac_lut.lookup((uint32_t)(br.bits >> 48));
  int len = e & 0xFF;
  if (__builtin_expect(len == 0, 0)) return 2;
  int sym = e >> 8;
  if (sym == 0x00) {
    br.bits <<= len;
    br.count -= len;
    return 1;
  }
  if (sym == 0xF0) {
    br.bits <<= len;
    br.count -= len;
    k += (64 - k < 16) ? (64 - k) : 16;
    return 0;
  }
  int size = sym & 0xF;
  int total = len + size;
  uint32_t raw = (uint32_t)((br.bits >> (64 - total)) & ((1u << size) - 1));
  br.bits <<= total;
  br.count -= total;
  int32_t v = value_correction(raw, size);
  int run = (sym >> 4) & 0xF;
  int cap = 64 - k - 1;
  k += (run < cap) ? run : cap;
  plane[zoff[k++]] = (int16_t)v;
  return 0;
}

// Buffered-tile variant: decode into a zeroed L1-resident 8x8 tile,
// then store out as eight contiguous 16B rows. The full-tile stores
// write the same 128B/block the bulk prezero pass would, so the
// separate 25MB zeroing sweep over the planes disappears entirely
// (prezero mode 3) while the in-tile memset stays cache-hot.
inline int next_block_plane_buf(BitReader& br, const TwoLevelLut& dc_lut,
                                const TwoLevelLut& ac_lut,
                                const FastLut& dc_fast,
                                const PairLut& ac_pair, int16_t* plane,
                                int64_t stride, const int32_t* zoff8,
                                int32_t* prev_dc) {
  alignas(32) int16_t tile[64];
  std::memset(tile, 0, sizeof(tile));
  if (dc_step_plane(br, dc_lut, dc_fast, tile, prev_dc)) return 1;
  int k = 1;
  while (k < 64) {
    int r = ac_step_plane(br, ac_lut, ac_pair, tile, zoff8, k);
    if (r) {
      if (r != 1) return 2;
      break;
    }
  }
  for (int r = 0; r < 8; ++r)
    std::memcpy(plane + r * stride, tile + r * 8, 16);
  return 0;
}

template <bool kZeroTile>
inline int next_block_plane(BitReader& br, const TwoLevelLut& dc_lut,
                            const TwoLevelLut& ac_lut, const FastLut& dc_fast,
                            const PairLut& ac_pair, int16_t* plane,
                            int64_t stride, const int32_t* zoff,
                            int32_t* prev_dc) {
  if constexpr (kZeroTile) {
    // Zero the 8x8 destination tile (prezero=1 legacy mode). The bulk
    // prezero modes skip this: strided 16B stores cost ~17%% of the whole
    // decode; a caller-guaranteed zero buffer (fresh calloc or the bulk
    // zero phase) makes the sparse coefficient writes sufficient.
    for (int r = 0; r < 8; ++r) {
      std::memset(plane + r * stride, 0, 8 * sizeof(int16_t));
    }
  }
  if (dc_step_plane(br, dc_lut, dc_fast, plane, prev_dc)) return 1;
  int k = 1;
  while (k < 64) {
    int r = ac_step_plane(br, ac_lut, ac_pair, plane, zoff, k);
    if (r) return r == 1 ? 0 : 2;
  }
  return 0;
}

// A two-stream interleaved variant (decode one block from each of two
// independent restart segments per call, zstd multi-stream style) was
// built on these step helpers and A/B'd (tools/ab_host_entropy.py,
// interleaved rounds): corpus 229.7 vs 227.2 fps single-stream — no
// gain. The symbol loop is mispredict-bound (data-dependent kind
// dispatch), not latency-bound, and a second stream cannot hide
// pipeline flushes. Removed; the helpers stay for the refactor.

struct PlaneJob {
  const uint8_t* data;
  const int64_t* seg_start;
  const int64_t* seg_end;
  const int64_t* seg_mcu_start;
  const int64_t* seg_mcu_count;
  int64_t n_segs;
  const uint8_t* slot_comp;  // [bpm]
  const uint8_t* slot_vi;    // [bpm] vertical sub-block index within MCU
  const uint8_t* slot_hi;    // [bpm]
  int32_t blocks_per_mcu;
  const uint8_t* comp_dc_id;
  const uint8_t* comp_ac_id;
  const uint8_t* comp_h;  // [n_comp] sampling factors
  const uint8_t* comp_v;
  int32_t n_comp;
  int32_t mcus_x;
  const uint16_t* dc_luts;
  const uint16_t* ac_luts;
  int16_t* const* planes;      // [n_comp] plane base pointers
  const int64_t* plane_stride;  // [n_comp] row stride (elements)
  const int64_t* plane_rows;    // [n_comp] allocated rows (prezero=2)
};

template <bool kZeroTile, bool kBuffered = false>
void decode_segments_planes(const PlaneJob& job, std::atomic<int64_t>* next,
                            int64_t n_segs,
                            std::atomic<int64_t>* first_error) {
  static constexpr int32_t kZoff8[64] = {
      0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
      12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
      35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
      58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
  const int bpm = job.blocks_per_mcu;
  TwoLevelLut dc_tab[4], ac_tab[4];
  FastLut dc_fast[4];
  PairLut ac_pair[4];
  bool dc_built[4] = {}, ac_built[4] = {};
  const TwoLevelLut* slot_dc[64];
  const TwoLevelLut* slot_ac[64];
  const FastLut* slot_dcf[64];
  const PairLut* slot_acf[64];
  int slot_ci[64];
  int32_t zoff[8][64];  // per component: zigzag k -> plane offset
  for (int c = 0; c < job.n_comp; ++c) {
    int64_t st = job.plane_stride[c];
    for (int k = 0; k < 64; ++k) zoff[c][k] = (int32_t)(kZigRow[k] * st + kZigCol[k]);
  }
  for (int s = 0; s < bpm; ++s) {
    int c = job.slot_comp[s];
    slot_ci[s] = c;
    int di = job.comp_dc_id[c], ai = job.comp_ac_id[c];
    if (!dc_built[di]) {
      dc_tab[di].build(job.dc_luts + di * kLutSize);
      dc_fast[di].build(job.dc_luts + di * kLutSize, true);
      dc_built[di] = true;
    }
    if (!ac_built[ai]) {
      ac_tab[ai].build(job.ac_luts + ai * kLutSize);
      ac_pair[ai].build(job.ac_luts + ai * kLutSize);
      ac_built[ai] = true;
    }
    slot_dc[s] = &dc_tab[di];
    slot_ac[s] = &ac_tab[ai];
    slot_dcf[s] = &dc_fast[di];
    slot_acf[s] = &ac_pair[ai];
  }
  // Work stealing: segment sizes skew on real-world content (detail
  // concentrates in bands), so threads pull the next segment from a
  // shared counter instead of fixed contiguous slices.
  for (int64_t s; (s = next->fetch_add(1)) < n_segs;) {
    BitReader br(job.data + job.seg_start[s],
                 job.seg_end[s] - job.seg_start[s]);
    int32_t prev_dc[4] = {0, 0, 0, 0};
    int64_t mcu = job.seg_mcu_start[s];
    for (int64_t m = 0; m < job.seg_mcu_count[s]; ++m, ++mcu) {
      int64_t my = mcu / job.mcus_x;
      int64_t mx = mcu % job.mcus_x;
      // Destination-line prefetch one block ahead was A/B'd here
      // (tools/ab_host_entropy.py): no win — the bulk-prezero pass has
      // already touched every line, so the decode's first stores hit.
      for (int slot = 0; slot < bpm; ++slot) {
        int c = slot_ci[slot];
        int64_t st = job.plane_stride[c];
        int64_t by = my * job.comp_v[c] + job.slot_vi[slot];
        int64_t bx = mx * job.comp_h[c] + job.slot_hi[slot];
        int16_t* dst = job.planes[c] + by * 8 * st + bx * 8;
        int err = kBuffered
                      ? next_block_plane_buf(
                            br, *slot_dc[slot], *slot_ac[slot],
                            *slot_dcf[slot], *slot_acf[slot], dst, st,
                            kZoff8, &prev_dc[c])
                      : next_block_plane<kZeroTile>(
                            br, *slot_dc[slot], *slot_ac[slot],
                            *slot_dcf[slot], *slot_acf[slot], dst, st,
                            zoff[c], &prev_dc[c]);
        if (__builtin_expect(err != 0, 0)) {
          int64_t expect = -1;
          first_error->compare_exchange_strong(expect, s);
          return;
        }
      }
    }
  }
}


// Bulk plane zeroing for prezero=2: thread t zeroes its contiguous row
// slice of every plane (streaming 64B-line stores beat the per-tile 16B
// strided stores by ~2-3x in bytes/cycle).
void zero_plane_slice(const PlaneJob& job, int t, int nt) {
  for (int c = 0; c < job.n_comp; ++c) {
    int64_t st = job.plane_stride[c];
    int64_t rows = job.plane_rows[c];
    int64_t r0 = rows * t / nt, r1 = rows * (t + 1) / nt;
    if (r1 > r0)
      std::memset(job.planes[c] + r0 * st, 0,
                  (size_t)(r1 - r0) * st * sizeof(int16_t));
  }
}

// Persistent worker pool. Every hot entry point used to spawn 4-8
// std::threads PER FRAME (~60-100us each on this VM): at the 4K
// no-restart rate that was ~10% of the frame. Workers park on a
// condition variable between dispatches. The caller participates as
// worker 0. A second concurrent dispatch (e.g. two Python threads each
// asking for a multi-threaded decode) falls back to ad-hoc spawning —
// the corpus path uses n_threads=1 per worker, so contention is rare.
// fork() safety: the pool detects a pid change and abandons the
// (nonexistent-in-child) threads.
class WorkerPool {
 public:
  static WorkerPool& inst() {
    // Leaked: a static destructor would tear down the mutex/cv while
    // parked workers still wait on them (hung process at exit). The
    // parked threads die with the process.
    static WorkerPool* p = new WorkerPool();
    return *p;
  }

  // Run fn(t) for t in [0, n); returns when all n are done.
  void run(int n, const std::function<void(int)>& fn) {
    if (n <= 1) {
      fn(0);
      return;
    }
    std::unique_lock<std::mutex> dl(dispatch_m_, std::try_to_lock);
    if (!dl.owns_lock()) {
      std::vector<std::thread> ts;
      ts.reserve(n - 1);
      for (int t = 1; t < n; ++t) ts.emplace_back(fn, t);
      fn(0);
      for (auto& th : ts) th.join();
      return;
    }
    {
      std::unique_lock<std::mutex> lk(m_);
      if (pid_ != getpid()) {  // forked child: threads didn't survive
        threads_ = {};         // leak the stale handles deliberately
        pid_ = getpid();
        gen_ = 0;              // fresh threads must not see stale state
        want_ = 0;
      }
      while ((int)threads_.size() < n - 1) {
        int id = (int)threads_.size() + 1;
        // Leaked on purpose at process exit: joining at static
        // destruction races ctypes dlclose; workers are parked and die
        // with the process.
        threads_.push_back(new std::thread([this, id] { loop(id); }));
        threads_.back()->detach();
      }
      fn_ = &fn;
      want_ = n - 1;
      done_ = 0;
      ++gen_;
    }
    cv_.notify_all();
    fn(0);
    std::unique_lock<std::mutex> lk(m_);
    cv_done_.wait(lk, [&] { return done_ == want_; });
    fn_ = nullptr;
  }

 private:
  void loop(int id) {
    uint64_t seen = 0;
    for (;;) {
      const std::function<void(int)>* f;
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_.wait(lk, [&] { return gen_ != seen && id <= want_; });
        seen = gen_;
        f = fn_;
      }
      (*f)(id);
      {
        std::unique_lock<std::mutex> lk(m_);
        if (++done_ == want_) cv_done_.notify_one();
      }
    }
  }

  std::mutex dispatch_m_;  // serializes whole dispatches
  std::mutex m_;
  std::condition_variable cv_, cv_done_;
  std::vector<std::thread*> threads_;
  const std::function<void(int)>* fn_ = nullptr;
  uint64_t gen_ = 0;
  int want_ = 0, done_ = 0;
  pid_t pid_ = getpid();
};

inline void pool_run(int n, const std::function<void(int)>& fn) {
  WorkerPool::inst().run(n, fn);
}

struct ScanJob {
  const uint8_t* data;
  const int64_t* seg_start;
  const int64_t* seg_end;
  const int64_t* seg_mcu_start;
  const int64_t* seg_mcu_count;
  int64_t n_segs;
  const uint8_t* slot_comp;  // [blocks_per_mcu] component index per slot
  int32_t blocks_per_mcu;
  const uint8_t* comp_dc_id;  // [n_comp]
  const uint8_t* comp_ac_id;
  int32_t n_comp;
  const uint16_t* dc_luts;  // [4][65536] packed (value<<8)|length
  const uint16_t* ac_luts;
  int32_t* out;  // [total_blocks * 64], pre-zeroed by caller
};

// Decode segments [lo, hi). Each restart segment is independent: byte-aligned
// start, DC predictors reset (JPEG F.2.1.3.1) — this is what makes host
// entropy decode parallel (the reference is strictly sequential).
void decode_segments(const ScanJob& job, std::atomic<int64_t>* next,
                     int64_t n_segs, std::atomic<int64_t>* first_error) {
  const int bpm = job.blocks_per_mcu;
  // Per-slot two-level + value-fused tables, hoisted out of the MCU loop.
  TwoLevelLut dc_tab[4], ac_tab[4];
  FastLut dc_fast[4];
  PairLut ac_pair[4];
  bool dcb[4] = {}, acb[4] = {};
  const TwoLevelLut* slot_dc[64];
  const TwoLevelLut* slot_ac[64];
  const FastLut* slot_dcf[64];
  const PairLut* slot_acf[64];
  int slot_ci[64];
  for (int s = 0; s < bpm; ++s) {
    int c = job.slot_comp[s];
    slot_ci[s] = c;
    int di = job.comp_dc_id[c], ai = job.comp_ac_id[c];
    if (!dcb[di]) {
      dc_tab[di].build(job.dc_luts + di * kLutSize);
      dc_fast[di].build(job.dc_luts + di * kLutSize, true);
      dcb[di] = true;
    }
    if (!acb[ai]) {
      ac_tab[ai].build(job.ac_luts + ai * kLutSize);
      ac_pair[ai].build(job.ac_luts + ai * kLutSize);
      acb[ai] = true;
    }
    slot_dc[s] = &dc_tab[di];
    slot_ac[s] = &ac_tab[ai];
    slot_dcf[s] = &dc_fast[di];
    slot_acf[s] = &ac_pair[ai];
  }
  for (int64_t s; (s = next->fetch_add(1)) < n_segs;) {
    BitReader br(job.data + job.seg_start[s],
                 job.seg_end[s] - job.seg_start[s]);
    int32_t prev_dc[4] = {0, 0, 0, 0};
    int32_t* out = job.out + job.seg_mcu_start[s] * bpm * 64;
    for (int64_t m = 0; m < job.seg_mcu_count[s]; ++m) {
      for (int slot = 0; slot < bpm; ++slot) {
        int err = next_block(br, *slot_dc[slot], *slot_ac[slot],
                             *slot_dcf[slot], *slot_acf[slot], out);
        if (__builtin_expect(err != 0, 0)) {
          int64_t expect = -1;
          first_error->compare_exchange_strong(expect, s);
          return;  // abandon this segment; others unaffected
        }
        int c = slot_ci[slot];
        out[0] += prev_dc[c];
        prev_dc[c] = out[0];
        out += 64;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Speculative self-synchronizing parallel decode for streams WITHOUT restart
// markers (SURVEY.md §5 mechanism (b), after "Accelerating JPEG Decompression
// on GPUs", arXiv 2111.09219). Huffman streams self-synchronize: a decoder
// started at a wrong bit position usually re-aligns with the true symbol
// stream within a few MCUs. Phase A decodes each byte-aligned chunk
// speculatively (positions only) and records candidate MCU-start bit
// offsets; a sequential merge intersects each thread's overlap positions
// with the next thread's record — a common position chained from the
// ground-truth start IS a true MCU boundary with the right table phase.
// Phase B re-decodes the verified ranges in parallel with local DC
// predictors, then a fix-up pass adds the per-range DC corrections
// (prefix sums of the per-range delta totals). Any broken sync link falls
// back to sequential decode of the remainder — always correct, speedup
// opportunistic.

// Skip one block (positions only). Returns 0 ok, nonzero on invalid prefix.
inline int skip_block(BitReader& br, const TwoLevelLut& dc_lut,
                      const TwoLevelLut& ac_lut) {
  if (br.count < 31) br.refill();
  uint32_t e = dc_lut.lookup((uint32_t)(br.bits >> 48));
  int len = e & 0xFF;
  if (__builtin_expect(len == 0, 0)) return 1;
  int total = len + (e >> 8);
  br.bits <<= total;
  br.count -= total;
  int k = 1;
  while (k < 64) {
    if (br.count < 31) br.refill();
    e = ac_lut.lookup((uint32_t)(br.bits >> 48));
    len = e & 0xFF;
    if (__builtin_expect(len == 0, 0)) return 2;
    int sym = e >> 8;
    if (sym == 0x00) {
      br.bits <<= len;
      br.count -= len;
      break;
    }
    if (__builtin_expect(sym == 0xF0, 0)) {
      br.bits <<= len;
      br.count -= len;
      k += (64 - k < 16) ? (64 - k) : 16;
      continue;
    }
    total = len + (sym & 0xF);
    br.bits <<= total;
    br.count -= total;
    k += ((sym >> 4) & 0xF) + 1;
  }
  return 0;
}

struct SpecThreadResult {
  std::vector<int64_t> mcu_bits;  // candidate MCU-start bit offsets (abs)
  bool ok = false;
};

// Absolute bit position of a reader that started at data+base_byte.
inline int64_t reader_bitpos(const BitReader& br, const uint8_t* data,
                             int64_t base_byte) {
  return (base_byte + (br.p - data)) * 8 - br.count;
}

// ---------------------------------------------------------------------------
// Arithmetic-coded (SOF9) entropy decode: the QM coder of T.81 Annex D/E
// with the sequential DC/AC statistical models of F.1.4.4 — the production
// twin of jpeg_tpu.entropy.arith (equivalence-tested; that module documents
// the register semantics, verified against the system libjpeg). Restart
// segments decode thread-parallel exactly like the Huffman path.

struct QeEntry {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

// T.81 Table D.3 (113 adaptive states + the fixed ~0.5 bin at 113).
constexpr QeEntry kQeTable[114] = {
    {0x5A1D, 1, 1, 1}, {0x2586, 2, 14, 0}, {0x1114, 3, 16, 0}, {0x080B, 4, 18, 0},
    {0x03D8, 5, 20, 0}, {0x01DA, 6, 23, 0}, {0x00E5, 7, 25, 0}, {0x006F, 8, 28, 0},
    {0x0036, 9, 30, 0}, {0x001A, 10, 33, 0}, {0x000D, 11, 35, 0}, {0x0006, 12, 9, 0},
    {0x0003, 13, 10, 0}, {0x0001, 13, 12, 0}, {0x5A7F, 15, 15, 1}, {0x3F25, 16, 36, 0},
    {0x2CF2, 17, 38, 0}, {0x207C, 18, 39, 0}, {0x17B9, 19, 40, 0}, {0x1182, 20, 42, 0},
    {0x0CEF, 21, 43, 0}, {0x09A1, 22, 45, 0}, {0x072F, 23, 46, 0}, {0x055C, 24, 48, 0},
    {0x0406, 25, 49, 0}, {0x0303, 26, 51, 0}, {0x0240, 27, 52, 0}, {0x01B1, 28, 54, 0},
    {0x0144, 29, 56, 0}, {0x00F5, 30, 57, 0}, {0x00B7, 31, 59, 0}, {0x008A, 32, 60, 0},
    {0x0068, 33, 62, 0}, {0x004E, 34, 63, 0}, {0x003B, 35, 32, 0}, {0x002C, 9, 33, 0},
    {0x5AE1, 37, 37, 1}, {0x484C, 38, 64, 0}, {0x3A0D, 39, 65, 0}, {0x2EF1, 40, 67, 0},
    {0x261F, 41, 68, 0}, {0x1F33, 42, 69, 0}, {0x19A8, 43, 70, 0}, {0x1518, 44, 72, 0},
    {0x1177, 45, 73, 0}, {0x0E74, 46, 74, 0}, {0x0BFB, 47, 75, 0}, {0x09F8, 48, 77, 0},
    {0x0861, 49, 78, 0}, {0x0706, 50, 79, 0}, {0x05CD, 51, 48, 0}, {0x04DE, 52, 50, 0},
    {0x040F, 53, 50, 0}, {0x0363, 54, 51, 0}, {0x02D4, 55, 52, 0}, {0x025C, 56, 53, 0},
    {0x01F8, 57, 54, 0}, {0x01A4, 58, 55, 0}, {0x0160, 59, 56, 0}, {0x0125, 60, 57, 0},
    {0x00F6, 61, 58, 0}, {0x00CB, 62, 59, 0}, {0x00AB, 63, 61, 0}, {0x008F, 32, 61, 0},
    {0x5B12, 65, 65, 1}, {0x4D04, 66, 80, 0}, {0x412C, 67, 81, 0}, {0x37D8, 68, 82, 0},
    {0x2FE8, 69, 83, 0}, {0x293C, 70, 84, 0}, {0x2379, 71, 86, 0}, {0x1EDF, 72, 87, 0},
    {0x1AA9, 73, 87, 0}, {0x174E, 74, 72, 0}, {0x1424, 75, 72, 0}, {0x119C, 76, 74, 0},
    {0x0F6B, 77, 74, 0}, {0x0D51, 78, 75, 0}, {0x0BB6, 79, 77, 0}, {0x0A40, 48, 77, 0},
    {0x5832, 81, 80, 1}, {0x4D1C, 82, 88, 0}, {0x438E, 83, 89, 0}, {0x3BDD, 84, 90, 0},
    {0x34EE, 85, 91, 0}, {0x2EAE, 86, 92, 0}, {0x299A, 87, 93, 0}, {0x2516, 71, 86, 0},
    {0x5570, 89, 88, 1}, {0x4CA9, 90, 95, 0}, {0x44D9, 91, 96, 0}, {0x3E22, 92, 97, 0},
    {0x3824, 93, 99, 0}, {0x32B4, 94, 99, 0}, {0x2E17, 86, 93, 0}, {0x56A8, 96, 95, 1},
    {0x4F46, 97, 101, 0}, {0x47E5, 98, 102, 0}, {0x41CF, 99, 103, 0}, {0x3C3D, 100, 104, 0},
    {0x375E, 93, 99, 0}, {0x5231, 102, 105, 0}, {0x4C0F, 103, 106, 0}, {0x4639, 104, 107, 0},
    {0x415E, 99, 103, 0}, {0x5627, 106, 105, 1}, {0x50E7, 107, 108, 0}, {0x4B85, 103, 109, 0},
    {0x5597, 109, 110, 0}, {0x504F, 107, 111, 0}, {0x5A10, 111, 110, 1}, {0x5522, 109, 112, 0},
    {0x59EB, 111, 112, 1}, {0x5A1D, 113, 113, 0},
};
constexpr uint8_t kFixedBin = 113;

// Per-(state byte) packed transition table, indexed by the full state byte
// sv = (mps << 7) | index: [15:0] qe, [23:16] next sv on MPS adapt,
// [31:24] next sv on LPS adapt (MPS switch folded in). 256 x 4B = 1KB —
// one aligned load replaces the 6-byte struct load + switch branch.
struct QeSvTable {
  uint32_t t[256];
  QeSvTable() {
    for (int sv = 0; sv < 256; ++sv) {
      // Indices 114-127 are outside the 114-entry Qe table (T.81 Table
      // D.3 has states 0..113); they are unreachable from any valid
      // transition chain, so park them on the terminal state rather
      // than reading past the table (caught by the ASan sweep).
      int idx = sv & 0x7F;
      const QeEntry& e = kQeTable[idx <= (int)kFixedBin ? idx : kFixedBin];
      uint32_t mps = sv & 0x80;
      uint32_t nmps_sv = mps | e.nmps;
      uint32_t nlps_sv = (e.sw ? (mps ^ 0x80) : mps) | e.nlps;
      t[sv] = e.qe | (nmps_sv << 16) | (nlps_sv << 24);
    }
  }
};
const QeSvTable kQeSv;

// QM decoder, pre-aligned formulation: the 16-bit code register Chigh lives
// at bits [63:48] of `c`; bits [47:0] hold the next 48 raw stream bits
// (zero-filled past segment end, matching the deferred-renorm original and
// libjpeg). Renormalization is a single clz-sized shift of (a, c) together,
// so the hot MPS path is subtract-compare-return with no per-bit loop and
// no `aa << ct` on the compare. Bit-exact twin of
// jpeg_tpu.entropy.arith.QMDecoder (equivalence-tested vs the Python
// module and libjpeg-turbo's coder).
struct QMDecoder {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t c;
  uint32_t a = 0x10000;  // one past 16 bits at init, <= 0xFFFF after
  int pending = 0;       // valid stream bits in c[47:0]

  QMDecoder(const uint8_t* d, int64_t n) : p(d), end(d + n) {
    uint64_t b0 = (p < end) ? *p++ : 0;
    uint64_t b1 = (p < end) ? *p++ : 0;
    c = (b0 << 56) | (b1 << 48);
    refill();
  }

  inline void refill() {
    if (__builtin_expect(p + 4 <= end, 1)) {
      // One 4-byte big-endian load replaces up to 5 byte-loop iterations
      // (refill is only called with pending < 16, so 32 bits always fit).
      uint32_t w;
      std::memcpy(&w, p, 4);
      p += 4;
      c |= (uint64_t)__builtin_bswap32(w) << (16 - pending);
      pending += 32;
      return;
    }
    while (pending <= 40) {
      uint64_t b = (p < end) ? *p++ : 0;  // zero fill past segment end
      c |= b << (40 - pending);
      pending += 8;
    }
  }

  // aa in [1, 0x7FFF]: shift (a, c) up until a reaches [0x8000, 0xFFFF].
  inline void renorm(uint32_t aa) {
    int n = __builtin_clz(aa) - 16;
    a = aa << n;
    c <<= n;
    pending -= n;
    if (pending < 16) refill();
  }

  // Core bin decode with the state byte cached in a register: callers
  // looping on one context (mantissa bits) skip the per-bin state reload.
  inline int decode_ref(uint8_t& sv, uint8_t* st) {
    uint32_t e = kQeSv.t[sv];
    uint32_t qe = e & 0xFFFF;
    uint32_t aa = a - qe;
    uint32_t chigh = (uint32_t)(c >> 48);
    if (chigh < aa) {
      if (__builtin_expect((aa & 0x8000) != 0, 1)) {
        a = aa;
        return sv >> 7;  // fast MPS: no renorm, no state update
      }
      int bit = sv >> 7;
      if (qe > aa) {  // conditional exchange
        bit ^= 1;
        sv = (uint8_t)(e >> 24);
      } else {
        sv = (uint8_t)(e >> 16);
      }
      *st = sv;
      renorm(aa);
      return bit;
    }
    c -= (uint64_t)aa << 48;
    int bit = sv >> 7;
    if (qe > aa) {  // conditional exchange
      sv = (uint8_t)(e >> 16);
    } else {
      bit ^= 1;
      sv = (uint8_t)(e >> 24);
    }
    *st = sv;
    renorm(qe);
    return bit;
  }

  inline int decode(uint8_t* st) {
    uint8_t sv = *st;
    return decode_ref(sv, st);
  }

  // Specialized decode on the non-adaptive ~0.5 bin (sign bits): state 113
  // never changes (nmps = nlps = 113, sw = 0, MPS = 0), so the table load
  // and state write vanish; only the conditional-exchange bit flip remains.
  inline int decode_fixed() {
    constexpr uint32_t kQe = 0x5A1D;
    uint32_t aa = a - kQe;
    uint32_t chigh = (uint32_t)(c >> 48);
    if (chigh < aa) {
      if (__builtin_expect((aa & 0x8000) != 0, 1)) {
        a = aa;
        return 0;
      }
      int bit = (kQe > aa) ? 1 : 0;
      renorm(aa);
      return bit;
    }
    c -= (uint64_t)aa << 48;
    int bit = (kQe > aa) ? 0 : 1;
    renorm(kQe);
    return bit;
  }
};

struct ArithStats {
  uint8_t dc[4][64];
  uint8_t ac[4][256];
  uint8_t fixed;
  int32_t ctx[4];
  int32_t last_dc[4];

  void reset() {
    std::memset(this, 0, sizeof(*this));
    fixed = kFixedBin;
  }
};

// One DC difference (F.1.4.4.1). Returns 0 ok, 1 corrupt.
inline int qm_decode_dc(QMDecoder& dec, ArithStats& s, int tbl, int ci,
                        int L, int U) {
  uint8_t* st = s.dc[tbl];
  int base = s.ctx[ci];
  if (dec.decode(st + base) == 0) {
    s.ctx[ci] = 0;
    return 0;
  }
  int sign = dec.decode(st + base + 1);
  int i = base + 2 + sign;
  int m;
  if (dec.decode(st + i) == 0) {
    m = 0;
  } else {
    m = 1;
    i = 20;
    while (dec.decode(st + i)) {
      if ((m <<= 1) == 0x8000) return 1;
      ++i;
    }
  }
  if (m < (1 << L) >> 1) s.ctx[ci] = 0;
  else if (m > (1 << U) >> 1) s.ctx[ci] = 12 + sign * 4;
  else s.ctx[ci] = 4 + sign * 4;
  int v = m;
  i += 14;
  if (m > 1) {
    uint8_t sv = st[i];
    do {
      m >>= 1;
      if (dec.decode_ref(sv, st + i)) v |= m;
    } while (m > 1);
  }
  v += 1;
  s.last_dc[ci] += sign ? -v : v;
  return 0;
}

// AC coefficients 1..63 via callback-free zigzag offsets. Writes nonzeros
// through `put(k, v)`. Returns 0 ok, 1 corrupt.
template <typename Put>
inline int qm_decode_ac(QMDecoder& dec, ArithStats& s, int tbl, int kx,
                        Put put) {
  uint8_t* st_ac = s.ac[tbl];
  int k = 1;
  while (k <= 63) {
    uint8_t* st = st_ac + 3 * (k - 1);
    if (dec.decode(st)) return 0;  // EOB
    while (dec.decode(st + 1) == 0) {
      st += 3;
      if (++k > 63) return 1;
    }
    int sign = dec.decode_fixed();
    st += 2;
    int m;
    if (dec.decode(st) == 0) {
      m = 0;
    } else if (dec.decode(st) == 0) {
      m = 1;
    } else {
      m = 2;
      st = st_ac + (k <= kx ? 189 : 217);
      while (dec.decode(st)) {
        if ((m <<= 1) == 0x8000) return 1;
        ++st;
      }
    }
    int v = m;
    st += 14;
    if (m > 1) {
      uint8_t sv = *st;
      do {
        m >>= 1;
        if (dec.decode_ref(sv, st)) v |= m;
      } while (m > 1);
    }
    v += 1;
    put(k, sign ? -v : v);
    ++k;
  }
  return 0;
}


}  // namespace

extern "C" {

// Speculative no-restart parallel decode into int16 planes. Same output
// contract as jt_decode_scan_planes for a single segment. `n_chunks` chunks
// decode concurrently; returns -1 ok, or >=0 first failing chunk under the
// sequential fallback (i.e. truly corrupt stream).
int64_t jt_decode_scan_planes_spec(
    const uint8_t* data, int64_t n_bytes, int64_t n_mcus,
    const uint8_t* slot_comp, const uint8_t* slot_vi, const uint8_t* slot_hi,
    int32_t blocks_per_mcu, const uint8_t* comp_dc_id,
    const uint8_t* comp_ac_id, const uint8_t* comp_h, const uint8_t* comp_v,
    int32_t n_comp, int32_t mcus_x, const uint16_t* dc_luts,
    const uint16_t* ac_luts, int16_t* const* planes,
    const int64_t* plane_stride, const int64_t* plane_rows, int32_t prezero,
    int32_t n_chunks, int32_t n_threads) {
  constexpr int kOverlapMcus = 96;  // recorded past chunk end for syncing
  TwoLevelLut dc_tab[4], ac_tab[4];
  static thread_local FastLut spec_dc_fast[4];
  static thread_local PairLut spec_ac_pair[4];
  bool dcb[4] = {}, acb[4] = {};
  const TwoLevelLut* slot_dc[64];
  const TwoLevelLut* slot_ac[64];
  const FastLut* slot_dcf[64];
  const PairLut* slot_acf[64];
  for (int s = 0; s < blocks_per_mcu; ++s) {
    int c = slot_comp[s];
    int di = comp_dc_id[c], ai = comp_ac_id[c];
    if (!dcb[di]) {
      dc_tab[di].build(dc_luts + di * kLutSize);
      spec_dc_fast[di].build(dc_luts + di * kLutSize, true);
      dcb[di] = true;
    }
    if (!acb[ai]) {
      ac_tab[ai].build(ac_luts + ai * kLutSize);
      spec_ac_pair[ai].build(ac_luts + ai * kLutSize);
      acb[ai] = true;
    }
    slot_dc[s] = &dc_tab[di];
    slot_ac[s] = &ac_tab[ai];
    slot_dcf[s] = &spec_dc_fast[di];
    slot_acf[s] = &spec_ac_pair[ai];
  }

  int64_t K = std::max<int64_t>(1, std::min<int64_t>(n_chunks, n_bytes / 4096));
  std::vector<int64_t> chunk_byte(K + 1);
  for (int64_t k = 0; k <= K; ++k) chunk_byte[k] = n_bytes * k / K;

  // Phase timing (JT_SPEC_PROFILE=1): where a frame's wall time goes.
  static const bool kProf = [] {
    const char* e = getenv("JT_SPEC_PROFILE");
    return e && *e == '1';
  }();
  auto now = [] { return std::chrono::steady_clock::now(); };
  auto t0 = now();
  auto ms = [](auto a, auto b) {
    return std::chrono::duration<double, std::milli>(b - a).count();
  };

  // --- Phase A: speculative VALUE decode per chunk (single Huffman pass) ---
  // Round-1 design scanned positions only, then re-decoded verified ranges:
  // two full Huffman passes. Here each chunk decodes blocks into contiguous
  // stride-8 temp tiles during the speculative scan; verified ranges are then
  // RELOCATED into the planes (dense 128B copies + DC correction), which
  // costs memory bandwidth instead of a second bit-serial pass.
  // Temp budget: ~2x the chunk's fair share of MCUs (+ skew/overlap slack);
  // a parse exceeding it is treated as failed — the chain breaks there and
  // the tail decodes sequentially from the last verified sync.
  int64_t cap_mcus = std::min<int64_t>(
      n_mcus + kOverlapMcus + 2,
      2 * (n_mcus / K + 1) + 256 + kOverlapMcus);
  int64_t blk_cap = cap_mcus * blocks_per_mcu;
  // thread_local: reused across calls from the same (Python worker)
  // thread — no per-frame 50MB allocation churn. The spawned decode
  // threads receive raw pointers (their own thread_local instances would
  // be empty).
  static thread_local std::vector<int16_t> temp_store;
  static thread_local std::vector<int32_t> dc_store;
  // Grow-only: K*blk_cap is ~2*n_mcus*blocks + O(K) slack, so candidate
  // K values (the auto-tuner trials several) need nearly the same total.
  // Shrinking and regrowing across K changes cost a 30-40ms realloc +
  // page-fault spike per frame — measured with JT_SPEC_PROFILE, and the
  // spike landed in exactly the frames the chunk auto-tuner timed.
  if (temp_store.size() < (size_t)(K * blk_cap * 64))
    temp_store.resize((size_t)(K * blk_cap * 64));
  if (dc_store.size() < (size_t)(K * (cap_mcus + 1) * 4))
    dc_store.resize((size_t)(K * (cap_mcus + 1) * 4));
  int16_t* const temp_base = temp_store.data();
  int32_t* const dc_base = dc_store.data();

  struct ChunkRes {
    std::vector<int64_t> mcu_bits;  // recorded MCU-start bit offsets (abs)
    int64_t n_dec = 0;              // MCUs fully decoded into temp
    int64_t end_bit = 0;            // bit position after the last decode
    int64_t start_byte = -1;        // accepted byte-aligned start
    bool ok = false;
  };
  std::vector<ChunkRes> res(K);

  int32_t zoff8[64];  // zigzag offsets for the contiguous stride-8 tiles
  for (int kk = 0; kk < 64; ++kk) zoff8[kk] = kZigRow[kk] * 8 + kZigCol[kk];

  auto phase_a = [&](int64_t k) {
    int64_t limit_bit = (k + 1 < K) ? chunk_byte[k + 1] * 8 : n_bytes * 8;
    int16_t* temp = temp_base + (size_t)(k * blk_cap * 64);
    int32_t* dcc = dc_base + (size_t)(k * (cap_mcus + 1) * 4);
    for (int64_t start = chunk_byte[k];
         start < std::min(chunk_byte[k] + 4096, n_bytes); ++start) {
      ChunkRes r;
      r.start_byte = start;
      BitReader br(data + start, n_bytes - start);
      int64_t past_end = 0;
      bool bad = false;
      int32_t prev_dc[4] = {0, 0, 0, 0};
      for (int c = 0; c < 4; ++c) dcc[c] = 0;
      int64_t m = 0;
      int64_t pos = (int64_t)start * 8;
      while (true) {
        pos = (int64_t)start * 8 + reader_bitpos(br, data + start, 0);
        if (pos >= (int64_t)n_bytes * 8) break;
        if (m >= cap_mcus) {
          bad = true;  // budget exceeded: almost certainly a desynced parse
          break;
        }
        r.mcu_bits.push_back(pos);
        if (pos >= limit_bit && ++past_end > kOverlapMcus) break;
        for (int slot = 0; slot < blocks_per_mcu; ++slot) {
          int c = slot_comp[slot];
          int16_t* dst = temp + (m * blocks_per_mcu + slot) * 64;
          if (next_block_plane<true>(br, *slot_dc[slot], *slot_ac[slot],
                                     *slot_dcf[slot], *slot_acf[slot], dst, 8,
                                     zoff8, &prev_dc[c])) {
            bad = true;
            break;
          }
        }
        if (bad) break;
        ++m;
        for (int c = 0; c < 4; ++c) dcc[m * 4 + c] = prev_dc[c];
      }
      r.n_dec = m;
      r.end_bit = (int64_t)start * 8 + reader_bitpos(br, data + start, 0);
      // Heuristic acceptance: parsed to (or past) the chunk end.
      if (!bad || (!r.mcu_bits.empty() && r.mcu_bits.back() >= limit_bit)) {
        r.ok = true;
        res[k] = std::move(r);
        return;
      }
    }
    res[k].ok = false;
  };
  {
    int nt = (int)std::min<int64_t>(n_threads > 0 ? n_threads : 1, K);
    std::atomic<int64_t> next(0);
    // No plane prezero in speculative mode (any prezero value):
    // phase A zero-tiles its temp blocks, relocation copies COMPLETE
    // 128B tiles, and the sequential gap/tail spans below decode in
    // zero-tile mode — every real tile is fully written, so the old
    // bulk zero was ~25MB of redundant stores per 4K frame
    // (measured +14% fps when removed). Stride/band pad regions
    // never get written and are cropped off downstream.
    pool_run(nt, [&](int) {
      for (;;) {
        int64_t k = next.fetch_add(1);
        if (k >= K) return;
        phase_a(k);
      }
    });
  }
  auto t_a = now();

  // --- Merge: chain sync points from the ground-truth start ---
  // Chunk 0 is ground truth ONLY if its accepted parse starts at byte 0
  // (a retried start means the true parse from bit 0 failed -> corrupt
  // stream -> sequential fallback reproduces the sequential error).
  std::vector<int64_t> range_bit{0};
  std::vector<int64_t> range_mcu{0};
  std::vector<int64_t> range_chunk{0};
  std::vector<int64_t> range_idx{0};  // index into src chunk's recorded MCUs
  bool chain_ok = res[0].ok && res[0].start_byte == 0;
  int64_t mcu_base = 0;
  int64_t valid_from_idx = 0;
  for (int64_t k = 0; k + 1 < K && chain_ok; ++k) {
    const auto& a = res[k].mcu_bits;
    const auto& b = res[k + 1].mcu_bits;
    if (!res[k + 1].ok) {
      chain_ok = false;
      break;
    }
    int64_t boundary = chunk_byte[k + 1] * 8;
    size_t ia = valid_from_idx, ib = 0;
    while (ia < a.size() && a[ia] < boundary) ++ia;
    int64_t sync = -1, sync_ia = -1, sync_ib = -1;
    while (ia < a.size() && ib < b.size()) {
      if (a[ia] == b[ib]) {
        sync = a[ia];
        sync_ia = (int64_t)ia;
        sync_ib = (int64_t)ib;
        break;
      }
      if (a[ia] < b[ib]) ++ia;
      else ++ib;
    }
    if (sync < 0) {
      chain_ok = false;
      break;
    }
    int64_t sync_mcu = mcu_base + (sync_ia - valid_from_idx);
    if (sync_mcu >= n_mcus) break;
    range_bit.push_back(sync);
    range_mcu.push_back(sync_mcu);
    range_chunk.push_back(k + 1);
    range_idx.push_back(sync_ib);
    mcu_base = sync_mcu;
    valid_from_idx = sync_ib;
  }

  std::atomic<int64_t> first_error(-1);
  int32_t zoff_all[8][64];
  for (int c = 0; c < n_comp; ++c) {
    int64_t st = plane_stride[c];
    for (int kk = 0; kk < 64; ++kk)
      zoff_all[c][kk] = (int32_t)(kZigRow[kk] * st + kZigCol[kk]);
  }

  // Exact bitstream decode of MCUs [mcu0, mcu1) into the planes starting at
  // absolute bit `bit0` with initial DC predictors `dc0` (the fallback and
  // tail-continuation path; also the corrupt-stream path).
  auto decode_span = [&](int64_t bit0, int64_t mcu0, int64_t mcu1,
                         const int32_t* dc0, int64_t err_tag) {
    int64_t byte0 = bit0 >> 3;
    BitReader br(data + byte0, n_bytes - byte0);
    br.refill();
    int drop = (int)(bit0 & 7);
    br.bits <<= drop;
    br.count -= drop;
    int32_t prev_dc[4];
    for (int c = 0; c < 4; ++c) prev_dc[c] = dc0 ? dc0[c] : 0;
    for (int64_t mcu = mcu0; mcu < mcu1; ++mcu) {
      int64_t my = mcu / mcus_x;
      int64_t mx = mcu % mcus_x;
      for (int slot = 0; slot < blocks_per_mcu; ++slot) {
        int c = slot_comp[slot];
        int64_t st = plane_stride[c];
        int64_t by = my * comp_v[c] + slot_vi[slot];
        int64_t bx = mx * comp_h[c] + slot_hi[slot];
        int16_t* dst = planes[c] + by * 8 * st + bx * 8;
        // Zero-tile mode unconditionally: with the bulk plane zero gone,
        // sequential spans land on dirty tiles.
        int err =
            next_block_plane<true>(br, *slot_dc[slot], *slot_ac[slot],
                                   *slot_dcf[slot], *slot_acf[slot],
                                   dst, st, zoff_all[c], &prev_dc[c]);
        if (__builtin_expect(err != 0, 0)) {
          int64_t expect = -1;
          first_error.compare_exchange_strong(expect, err_tag);
          return;
        }
      }
    }
  };

  if (!chain_ok && range_bit.size() == 1) {
    // No verified parallelism at all: pure sequential (also the
    // corrupt-stream path). Relocating chunk 0's temp would replay a
    // possibly-retried parse, so decode straight from bit 0.
    if (res[0].ok && res[0].start_byte == 0 && res[0].n_dec > 0) {
      // Chunk 0 is ground truth: salvage its decode via relocation below.
    } else {
      decode_span(0, 0, n_mcus, nullptr, 0);
      return first_error.load() >= 0 ? 0 : -1;
    }
  }

  // --- DC prefix chain over ranges (exact, from recorded cumulatives) ---
  int64_t R = (int64_t)range_bit.size();
  std::vector<std::array<int32_t, 4>> global_before(R);
  std::vector<int64_t> range_take(R);
  for (int64_t r = 0; r < R; ++r) {
    int64_t cr = range_chunk[r];
    int64_t ia = range_idx[r];
    int64_t mcu1 = (r + 1 < R) ? range_mcu[r + 1] : n_mcus;
    int64_t cnt = mcu1 - range_mcu[r];
    int64_t avail = res[cr].n_dec - ia;
    range_take[r] = std::max<int64_t>(0, std::min(cnt, avail));
    if (r == 0) {
      global_before[0] = {0, 0, 0, 0};
    }
    if (r + 1 < R) {
      const int32_t* dcc = dc_base + (size_t)(cr * (cap_mcus + 1) * 4);
      // Middle ranges always have take == cnt (the next sync index lies
      // within this chunk's decoded prefix).
      for (int c = 0; c < 4; ++c)
        global_before[r + 1][c] =
            global_before[r][c] +
            (dcc[(ia + range_take[r]) * 4 + c] - dcc[ia * 4 + c]);
    }
  }

  // --- Relocation: dense 128B tile copies + DC correction, parallel ---
  // (Non-temporal 16B stores were A/B'd here and REJECTED: a tile row is
  // 16B but a WC buffer is a full 64B line, so strided 16B streams leave
  // every line 3/4-partial and the flushes cost 22ms vs memcpy's 1.1ms,
  // measured with JT_SPEC_PROFILE on the 4K no-restart stream.)
  auto relocate = [&](int64_t r) {
    int64_t cr = range_chunk[r];
    int64_t ia = range_idx[r];
    int64_t mcu0 = range_mcu[r];
    int64_t mcu1 = (r + 1 < R) ? range_mcu[r + 1] : n_mcus;
    int64_t take = range_take[r];
    const int16_t* temp = temp_base + (size_t)(cr * blk_cap * 64);
    const int32_t* dcc = dc_base + (size_t)(cr * (cap_mcus + 1) * 4);
    int32_t corr[4];
    for (int c = 0; c < 4; ++c)
      corr[c] = global_before[r][c] - dcc[ia * 4 + c];
    for (int64_t m = 0; m < take; ++m) {
      int64_t gm = mcu0 + m;
      int64_t my = gm / mcus_x;
      int64_t mx = gm % mcus_x;
      const int16_t* src_mcu = temp + ((ia + m) * blocks_per_mcu) * 64;
      for (int slot = 0; slot < blocks_per_mcu; ++slot) {
        int c = slot_comp[slot];
        int64_t st = plane_stride[c];
        int64_t by = my * comp_v[c] + slot_vi[slot];
        int64_t bx = mx * comp_h[c] + slot_hi[slot];
        int16_t* dst = planes[c] + by * 8 * st + bx * 8;
        const int16_t* src = src_mcu + slot * 64;
        for (int row = 0; row < 8; ++row)
          std::memcpy(dst + row * st, src + row * 8, 16);
        dst[0] = (int16_t)((int32_t)src[0] + corr[c]);
      }
    }
    if (take < mcu1 - mcu0) {
      // Tail past this chunk's decoded prefix (stream end / early stop):
      // continue exactly from the last decoded position.
      const auto& bits = res[cr].mcu_bits;
      int64_t cont_bit = ((size_t)(ia + take) < bits.size())
                             ? bits[ia + take]
                             : res[cr].end_bit;
      int32_t dc0[4];
      for (int c = 0; c < 4; ++c)
        dc0[c] = global_before[r][c] +
                 (dcc[(ia + take) * 4 + c] - dcc[ia * 4 + c]);
      decode_span(cont_bit, mcu0 + take, mcu1, dc0, r);
    }
  };
  auto t_merge = now();
  {
    int nt = (int)std::min<int64_t>(n_threads > 0 ? n_threads : 1, R);
    std::atomic<int64_t> next(0);
    pool_run(nt, [&](int) {
      for (;;) {
        int64_t r = next.fetch_add(1);
        if (r >= R) return;
        relocate(r);
      }
    });
  }
  if (kProf) {
    auto t_end = now();
    int64_t tail = 0;
    for (int64_t r = 0; r < R; ++r) {
      int64_t mcu1 = (r + 1 < R) ? range_mcu[r + 1] : n_mcus;
      tail += (mcu1 - range_mcu[r]) - range_take[r];
    }
    fprintf(stderr,
            "[spec] K=%lld R=%lld phaseA=%.2fms merge=%.2fms reloc=%.2fms "
            "tail_mcus=%lld chain_ok=%d\n",
            (long long)K, (long long)R, ms(t0, t_a), ms(t_a, t_merge),
            ms(t_merge, t_end), (long long)tail, (int)chain_ok);
  }
  return first_error.load() >= 0 ? first_error.load() : -1;
}

// Lossless (SOF3, T.81 Annex H) decode: restart-segment-parallel
// difference decode, then one sequential prediction pass (the
// reconstruction recurrence crosses segments through Rb). Contract twin
// of jpeg_tpu.entropy.lossless (equivalence-tested): predictors 1-7,
// H.1.2.2 boundary rules, SSSS=16 => diff 32768 with no bits, mod-2^16
// arithmetic, output left-shifted by the point transform.
// Returns -1 ok, else the first failed segment index.
int64_t jt_decode_lossless(
    const uint8_t* data, const int64_t* seg_start, const int64_t* seg_end,
    const int64_t* seg_mcu_start, const int64_t* seg_mcu_count,
    int64_t n_segs, int32_t ncomp, const uint16_t* dc_luts,
    const int32_t* comp_dc_id, int64_t width, int64_t height,
    int32_t predictor, int32_t point_transform, int32_t precision,
    uint16_t* out, int32_t n_threads) {
  TwoLevelLut luts[4];
  bool built[4] = {};
  const TwoLevelLut* comp_lut[4];
  for (int c = 0; c < ncomp; ++c) {
    int id = comp_dc_id[c];
    if (!built[id]) {
      luts[id].build(dc_luts + id * kLutSize);
      built[id] = true;
    }
    comp_lut[c] = &luts[id];
  }

  // Phase 1: differences (mod 2^16) into `out`, parallel over segments.
  std::atomic<int64_t> first_error(-1);
  std::atomic<int64_t> next(0);
  int nt = (int)std::min<int64_t>(n_threads > 0 ? n_threads : 1, n_segs);
  pool_run(nt, [&](int) {
    for (;;) {
      int64_t s = next.fetch_add(1);
      if (s >= n_segs) return;
      BitReader br(data + seg_start[s], seg_end[s] - seg_start[s]);
      uint16_t* o = out + seg_mcu_start[s] * ncomp;
      int64_t n = seg_mcu_count[s] * ncomp;
      for (int64_t i = 0; i < n; ++i) {
        if (br.count < 31) br.refill();
        uint32_t e = comp_lut[i % ncomp]->lookup((uint32_t)(br.bits >> 48));
        int len = e & 0xFF;
        if (__builtin_expect(len == 0, 0)) {
          int64_t expect = -1;
          first_error.compare_exchange_strong(expect, s);
          return;
        }
        br.consume(len);
        int ssss = e >> 8;
        int32_t diff;
        if (ssss == 16) {
          diff = 32768;  // H.2 Table H.2: no additional bits
        } else if (ssss == 0) {
          diff = 0;
        } else {
          uint32_t v = br.read(ssss);
          diff = (v >> (ssss - 1)) ? (int32_t)v
                                   : (int32_t)v - (1 << ssss) + 1;
        }
        o[i] = (uint16_t)diff;
      }
    }
  });
  if (first_error.load() >= 0) return first_error.load();

  // Phase 2: sequential reconstruction in place (reads reconstructed
  // samples only at positions already passed).
  const int32_t def = 1 << (precision - point_transform - 1);
  for (int64_t s = 0; s < n_segs; ++s) {
    int64_t first_m = seg_mcu_start[s];
    int64_t first_y = first_m / width;
    int64_t m_end = first_m + seg_mcu_count[s];
    for (int64_t m = first_m; m < m_end; ++m) {
      int64_t y = m / width, x = m % width;
      uint16_t* row = out + m * ncomp;
      for (int c = 0; c < ncomp; ++c) {
        int32_t px;
        if (m == first_m) {
          px = def;
        } else if (y == first_y) {
          px = row[c - ncomp];  // Ra (rest of the interval's first line)
        } else if (x == 0) {
          px = *(row + c - width * ncomp);  // Rb
        } else {
          int32_t ra = row[c - ncomp];
          int32_t rb = *(row + c - width * ncomp);
          int32_t rc_ = *(row + c - (width + 1) * ncomp);
          switch (predictor) {
            case 1: px = ra; break;
            case 2: px = rb; break;
            case 3: px = rc_; break;
            case 4: px = ra + rb - rc_; break;
            case 5: px = ra + ((rb - rc_) >> 1); break;
            case 6: px = rb + ((ra - rc_) >> 1); break;
            default: px = (ra + rb) >> 1; break;
          }
        }
        row[c] = (uint16_t)(px + (int16_t)row[c]);
      }
    }
  }
  if (point_transform) {
    int64_t n = width * height * ncomp;
    for (int64_t i = 0; i < n; ++i) out[i] <<= point_transform;
  }
  return -1;
}

// Returns -1 on success, else the index of the first failed segment.
int64_t jt_decode_scan(const uint8_t* data, int64_t /*n_bytes*/,
                       const int64_t* seg_start, const int64_t* seg_end,
                       const int64_t* seg_mcu_start,
                       const int64_t* seg_mcu_count, int64_t n_segs,
                       const uint8_t* slot_comp, int32_t blocks_per_mcu,
                       const uint8_t* comp_dc_id, const uint8_t* comp_ac_id,
                       int32_t n_comp, const uint16_t* dc_luts,
                       const uint16_t* ac_luts, int32_t* out,
                       int32_t n_threads) {
  ScanJob job{data,          seg_start,  seg_end, seg_mcu_start,
              seg_mcu_count, n_segs,     slot_comp, blocks_per_mcu,
              comp_dc_id,    comp_ac_id, n_comp,    dc_luts,
              ac_luts,       out};
  std::atomic<int64_t> first_error(-1);
  std::atomic<int64_t> next(0);
  if (n_threads <= 1 || n_segs <= 1) {
    decode_segments(job, &next, n_segs, &first_error);
    return first_error.load();
  }
  int nt = (int)std::min<int64_t>(n_threads, n_segs);
  pool_run(nt,
           [&](int) { decode_segments(job, &next, n_segs, &first_error); });
  return first_error.load();
}

// Gap recovery for the speculative device merge (entropy/device_spec.py):
// sequentially decode whole MCUs from an arbitrary BIT position until the
// cursor lands on one of `stop_bits` (sorted ascending, absolute bit
// positions within `data`) or `max_mcus` are decoded. Blocks are written in
// zigzag order with RAW DC deltas (the caller applies prediction from its
// running base). out_pos[m] = absolute bit position after MCU m. The stop
// check runs BEFORE each MCU including the first (a start position already
// on a recorded MCU boundary decodes nothing). Returns the number of MCUs
// decoded, or -(m+1) when MCU m hit an invalid prefix (genuine corruption;
// the caller falls back to the host tier's reference error semantics).
int64_t jt_decode_gap(const uint8_t* data, int64_t start_bit,
                      int64_t end_byte, const int64_t* stop_bits,
                      int64_t n_stop, int64_t max_mcus,
                      const uint8_t* slot_comp, int32_t blocks_per_mcu,
                      const uint8_t* comp_dc_id, const uint8_t* comp_ac_id,
                      int32_t /*n_comp*/, const uint16_t* dc_luts,
                      const uint16_t* ac_luts, int32_t* out,
                      int64_t* out_pos) {
  const int bpm = blocks_per_mcu;
  TwoLevelLut dc_tab[4], ac_tab[4];
  FastLut dc_fast[4];
  PairLut ac_pair[4];
  bool dcb[4] = {}, acb[4] = {};
  const TwoLevelLut* slot_dc[64];
  const TwoLevelLut* slot_ac[64];
  const FastLut* slot_dcf[64];
  const PairLut* slot_acf[64];
  for (int s = 0; s < bpm; ++s) {
    int c = slot_comp[s];
    int di = comp_dc_id[c], ai = comp_ac_id[c];
    if (!dcb[di]) {
      dc_tab[di].build(dc_luts + di * kLutSize);
      dc_fast[di].build(dc_luts + di * kLutSize, true);
      dcb[di] = true;
    }
    if (!acb[ai]) {
      ac_tab[ai].build(ac_luts + ai * kLutSize);
      ac_pair[ai].build(ac_luts + ai * kLutSize);
      acb[ai] = true;
    }
    slot_dc[s] = &dc_tab[di];
    slot_ac[s] = &ac_tab[ai];
    slot_dcf[s] = &dc_fast[di];
    slot_acf[s] = &ac_pair[ai];
  }
  const uint8_t* base = data + (start_bit >> 3);
  BitReader br(base, end_byte - (start_bit >> 3));
  if (start_bit & 7) {
    br.refill();
    br.consume((int)(start_bit & 7));
  }
  const int64_t base_bits = (start_bit >> 3) * 8;
  for (int64_t m = 0; m < max_mcus; ++m) {
    int64_t pos = base_bits + (int64_t)(br.p - base) * 8 - br.count;
    const int64_t* hit =
        std::lower_bound(stop_bits, stop_bits + n_stop, pos);
    if (hit != stop_bits + n_stop && *hit == pos) return m;
    for (int slot = 0; slot < bpm; ++slot) {
      int err = next_block(br, *slot_dc[slot], *slot_ac[slot],
                           *slot_dcf[slot], *slot_acf[slot], out);
      if (__builtin_expect(err != 0, 0)) return -(m + 1);
      out += 64;
    }
    out_pos[m] = base_bits + (int64_t)(br.p - base) * 8 - br.count;
  }
  return max_mcus;
}

// Plane-layout variant: decodes straight into per-component natural-order
// int16 planes (de-zigzag + DC prediction included). `planes` is an array of
// n_comp pointers; each plane [mcus_y*v*8, stride] must be allocated by the
// caller (only the 8x8 tiles written here are touched; callers pad strides).
// Returns -1 on success, else the first failed segment index.
// `prezero`: 1 = zero each 8x8 tile inline (works on any dirty buffer),
// 0 = caller guarantees zeroed planes (fresh calloc) — the sparse
// coefficient writes alone suffice, 2 = bulk-zero the planes here
// (streaming, split across the decode threads, barrier, then decode as
// mode 0). Mode 2 on a reused buffer beats mode 1 by ~2-3x on the zeroing
// bytes/cycle; mode 0 is fastest when the allocator hands back zero pages.
int64_t jt_decode_scan_planes(
    const uint8_t* data, int64_t /*n_bytes*/, const int64_t* seg_start,
    const int64_t* seg_end, const int64_t* seg_mcu_start,
    const int64_t* seg_mcu_count, int64_t n_segs, const uint8_t* slot_comp,
    const uint8_t* slot_vi, const uint8_t* slot_hi, int32_t blocks_per_mcu,
    const uint8_t* comp_dc_id, const uint8_t* comp_ac_id,
    const uint8_t* comp_h, const uint8_t* comp_v, int32_t n_comp,
    int32_t mcus_x, const uint16_t* dc_luts, const uint16_t* ac_luts,
    int16_t* const* planes, const int64_t* plane_stride,
    const int64_t* plane_rows, int32_t prezero, int32_t n_threads) {
  PlaneJob job{data,       seg_start, seg_end,   seg_mcu_start,
               seg_mcu_count, n_segs,  slot_comp, slot_vi,
               slot_hi,    blocks_per_mcu,       comp_dc_id,
               comp_ac_id, comp_h,    comp_v,    n_comp,
               mcus_x,     dc_luts,   ac_luts,   planes,
               plane_stride, plane_rows};
  std::atomic<int64_t> first_error(-1);
  std::atomic<int64_t> next(0);
  if (n_threads <= 1 || n_segs <= 1) {
    if (prezero == 2) zero_plane_slice(job, 0, 1);
    if (prezero == 3)
      decode_segments_planes<false, true>(job, &next, n_segs, &first_error);
    else if (prezero == 1)
      decode_segments_planes<true>(job, &next, n_segs, &first_error);
    else
      decode_segments_planes<false>(job, &next, n_segs, &first_error);
    return first_error.load();
  }
  int nt = (int)std::min<int64_t>(n_threads, n_segs);
  std::atomic<int> zeroed(0);
  pool_run(nt, [&job, &first_error, &zeroed, &next, nt, n_segs,
                prezero](int t) {
    if (prezero == 2) {
      zero_plane_slice(job, t, nt);
      zeroed.fetch_add(1, std::memory_order_acq_rel);
      while (zeroed.load(std::memory_order_acquire) < nt)
        std::this_thread::yield();
    }
    if (prezero == 3)
      decode_segments_planes<false, true>(job, &next, n_segs, &first_error);
    else if (prezero == 1)
      decode_segments_planes<true>(job, &next, n_segs, &first_error);
    else
      decode_segments_planes<false>(job, &next, n_segs, &first_error);
  });
  return first_error.load();
}

// ---------------------------------------------------------------------------
// Progressive (SOF2) scan decode — JPEG F.2.2 semantics matching
// jpeg_tpu.entropy.progressive (the Python oracle). One call per scan;
// coefficient state lives in caller-owned int32 block grids
// [rows_b, cols_b, 64] (zigzag order) that accumulate across scans.

namespace {

inline int32_t prog_extend(BitReader& br, int s) {
  if (s == 0) return 0;
  return value_correction(br.read(s), s);
}

}  // namespace


// Nonzero-position bitmask of an int32[64] coefficient block (AVX2:
// 8 x 8-lane compares + movemask). Bit k set <=> coef[k] != 0.
inline uint64_t nonzero_mask64(const int32_t* coef) {
  uint64_t m = 0;
  const __m256i zero = _mm256_setzero_si256();
  for (int g = 0; g < 8; ++g) {
    __m256i v = _mm256_loadu_si256((const __m256i*)(coef + g * 8));
    __m256i eq = _mm256_cmpeq_epi32(v, zero);
    uint32_t bits = (uint32_t)_mm256_movemask_ps(_mm256_castsi256_ps(eq));
    m |= (uint64_t)(~bits & 0xFF) << (g * 8);
  }
  return m;
}

// Refinement correction bits for every nonzero position in `m` (ascending),
// batched: one multi-bit read covers up to 16 nonzeros instead of one
// read(1) per position. The apply step is BRANCHLESS: correction bits are
// ~50/50 at the margin, so a per-bit `if` costs ~0.5 mispredicts per
// nonzero (measured dominant in the 4K al=0 Y refinement scan).
inline void refine_nonzeros(BitReader& br, int32_t* coef, uint64_t m,
                            int32_t p1, int32_t m1) {
  while (m) {
    int take = __builtin_popcountll(m);
    if (take > 16) take = 16;
    uint32_t bits = br.read(take);
    for (int i = take - 1; i >= 0; --i) {
      int k = __builtin_ctzll(m);
      m &= m - 1;
      int32_t cv = coef[k];
      // apply iff stream bit set AND the al bit not already set
      // (every position in m is nonzero by construction).
      int32_t apply = -(int32_t)(((bits >> i) & 1u) &
                                 (uint32_t)((cv & p1) == 0));
      int32_t add = (cv >= 0) ? p1 : m1;  // cmov
      coef[k] = cv + (add & apply);
    }
  }
}

// DC scan (ss == 0). If `interleaved`, units are MCUs over the full grid
// with per-component sub-blocks; else a single component's exact block
// raster. Returns -1 ok, >= 0 first bad segment.
int64_t jt_decode_prog_dc(
    const uint8_t* data, const int64_t* seg_start, const int64_t* seg_end,
    int64_t n_segs, int64_t restart_units, int32_t ah, int32_t al,
    int32_t n_scan_comps, const int32_t* scan_comp_h,
    const int32_t* scan_comp_v, int32_t* const* state,
    const int64_t* state_cols, const uint16_t* dc_luts,
    const int32_t* scan_dc_ids, int32_t mcus_x, int64_t n_units,
    int32_t interleaved, const int64_t* comp_bw, int64_t unit_base) {
  TwoLevelLut dc_tab[4];
  bool built[4] = {};
  const TwoLevelLut* comp_dc[4];
  for (int s = 0; s < n_scan_comps; ++s) {
    int t = scan_dc_ids[s];
    if (!built[t]) {
      dc_tab[t].build(dc_luts + t * kLutSize);
      built[t] = true;
    }
    comp_dc[s] = &dc_tab[t];
  }
  int64_t unit = unit_base;
  // Running row/col (see jt_decode_prog_ac: div/mod per unit is measurable).
  int64_t rx = interleaved ? mcus_x : comp_bw[0];
  int64_t uy = unit / rx, ux = unit % rx;
  for (int64_t seg = 0; seg < n_segs && unit < n_units; ++seg) {
    BitReader br(data + seg_start[seg], seg_end[seg] - seg_start[seg]);
    int64_t pred[4] = {0, 0, 0, 0};
    for (int64_t u = 0; u < restart_units && unit < n_units;
         ++u, ++unit, (++ux == rx ? (ux = 0, ++uy) : 0)) {
      if (interleaved) {
        int64_t my = uy;
        int64_t mx = ux;
        for (int s = 0; s < n_scan_comps; ++s) {
          int h = scan_comp_h[s], v = scan_comp_v[s];
          for (int vi = 0; vi < v; ++vi) {
            for (int hi = 0; hi < h; ++hi) {
              // Compact DC grid (one int32 per block): DC scans touch only
              // coefficient 0, and 256B-strided writes into the full
              // [.., 64] grids made the first DC scan cache-miss-bound
              // (~22ms for a 4K frame vs ~2ms compact).
              int32_t* coef =
                  state[s] + (my * v + vi) * state_cols[s] + mx * h + hi;
              if (ah == 0) {
                if (br.count < 31) br.refill();
                uint32_t e = comp_dc[s]->lookup((uint32_t)(br.bits >> 48));
                int len = e & 0xFF;
                if (len == 0) return seg;
                br.consume(len);
                pred[s] += prog_extend(br, e >> 8);
                *coef = (int32_t)(pred[s] << al);
              } else {
                if (br.read(1)) *coef |= 1 << al;
              }
            }
          }
        }
      } else {
        int32_t* coef = state[0] + uy * state_cols[0] + ux;
        if (ah == 0) {
          if (br.count < 31) br.refill();
          uint32_t e = comp_dc[0]->lookup((uint32_t)(br.bits >> 48));
          int len = e & 0xFF;
          if (len == 0) return seg;
          br.consume(len);
          pred[0] += prog_extend(br, e >> 8);
          *coef = (int32_t)(pred[0] << al);
        } else {
          if (br.read(1)) *coef |= 1 << al;
        }
      }
    }
  }
  return -1;
}

// Fused refinement-symbol table (ah > 0 AC scans): one 11-bit lookup
// resolves symbol + fused sign bit (inserts) or symbol + fused EOB-run
// length bits. 2^11 x u32 = 8KB. Entry:
//   [1:0] kind: 0 miss, 1 EOB-run (value fused), 3 span step (insert/ZRL)
//   [6:2] total bits   [10:7] run   [11] sign (+p1 when set)
//   [12] has insert value (0 for ZRL)   [31:16] fused EOB-run value
constexpr int kRefBits = 11;
constexpr int kRefShift = 64 - kRefBits;

struct RefLut {
  uint32_t tab[(size_t)1 << kRefBits];

  void build(const uint16_t* full_lut) {
    for (int64_t key = 0; key < ((int64_t)1 << kRefBits); ++key) {
      tab[key] = 0;  // miss
      uint32_t e = full_lut[key << (kLutBits - kRefBits)];
      int len = e & 0xFF;
      if (len == 0 || len > kRefBits) continue;
      int rs = e >> 8;
      int r = rs >> 4, s = rs & 0xF;
      if (s == 0) {
        if (r == 15) {  // ZRL
          tab[key] = 3u | ((uint32_t)len << 2) | (15u << 7);
        } else {
          int total = len + r;
          if (total > kRefBits) continue;
          uint32_t extra =
              (uint32_t)(key >> (kRefBits - total)) & ((1u << r) - 1);
          uint32_t eobval = (1u << r) + extra;
          if (eobval > 0xFFFF) continue;
          tab[key] = 1u | ((uint32_t)total << 2) | (eobval << 16);
        }
      } else if (s == 1) {
        int total = len + 1;  // fused sign bit
        if (total > kRefBits) continue;
        uint32_t sign = (uint32_t)(key >> (kRefBits - total)) & 1u;
        tab[key] = 3u | ((uint32_t)total << 2) | ((uint32_t)r << 7) |
                   (sign << 11) | (1u << 12);
      }
      // s > 1: miss (slow path reports the invalid magnitude)
    }
  }
};

// AC scan (single component). Returns -1 ok, >= 0 first bad segment.
//
// Row-pipelined chains: successive AC scans of one component are strictly
// ordered (a later scan reads the coefficient state the earlier one
// wrote), but only per block — so the WHOLE chain runs concurrently with
// row-granular gating. `done_rows` (may be NULL) is this scan's published
// progress (block rows completed, release-stored; INT64_MAX on exit so
// consumers never deadlock on an error path); `gate_rows` (may be NULL)
// is the producer scan's counter, acquire-loaded before each row.
int64_t jt_decode_prog_ac(
    const uint8_t* data, const int64_t* seg_start, const int64_t* seg_end,
    int64_t n_segs, int64_t restart_blocks, int32_t ss, int32_t se,
    int32_t ah, int32_t al, int32_t* state, int64_t state_cols,
    const uint16_t* ac_luts, int32_t ac_id, int64_t bw, int64_t n_blocks,
    int64_t unit_base, int64_t* done_rows, const int64_t* gate_rows) {
  struct DoneGuard {  // publish "all rows done" on every exit path
    int64_t* d;
    ~DoneGuard() {
      if (d) __atomic_store_n(d, INT64_MAX, __ATOMIC_RELEASE);
    }
  } done_guard{done_rows};
  TwoLevelLut ac_tab;
  ac_tab.build(ac_luts + ac_id * kLutSize);
  static thread_local RefLut ref_lut;
  if (ah > 0) ref_lut.build(ac_luts + ac_id * kLutSize);
  const int32_t p1 = 1 << al;
  const int32_t m1 = -(1 << al);
  int64_t bi = unit_base;
  // Running (by, bx) instead of a 64-bit div/mod per block (20-40 cycles,
  // measured significant across the sparse refinement scans).
  int64_t by = bi / bw;
  int64_t bx = bi % bw;
  int64_t gate_seen = 0;
  for (int64_t seg = 0; seg < n_segs && bi < n_blocks; ++seg) {
    BitReader br(data + seg_start[seg], seg_end[seg] - seg_start[seg]);
    int64_t eobrun = 0;
    for (int64_t u = 0; u < restart_blocks && bi < n_blocks;
         ++u, ++bi,
         (bx == bw - 1 && done_rows
              ? (__atomic_store_n(done_rows, by + 1, __ATOMIC_RELEASE), 0)
              : 0),
         (++bx == bw ? (bx = 0, ++by) : 0)) {
      if (gate_rows && bx == 0 && gate_seen <= by) {
        int spins = 0;
        while ((gate_seen =
                    __atomic_load_n(gate_rows, __ATOMIC_ACQUIRE)) <= by) {
          if (++spins < 64) {
            _mm_pause();
          } else {
            // Oversubscribed cores (whole chains run concurrently): give
            // the producer the core instead of burning it on the spin.
            std::this_thread::yield();
          }
        }
      }
      int32_t* coef = state + (by * state_cols + bx) * 64;
      if (ah == 0) {
        if (eobrun > 0) {
          --eobrun;
          continue;
        }
        int k = ss;
        while (k <= se) {
          if (br.count < 31) br.refill();
          uint32_t e = ac_tab.lookup((uint32_t)(br.bits >> 48));
          int len = e & 0xFF;
          if (len == 0) return seg;
          br.consume(len);
          int rs = e >> 8;
          int r = rs >> 4, s = rs & 0xF;
          if (s == 0) {
            if (r != 15) {
              eobrun = ((int64_t)1 << r) - 1;
              if (r) eobrun += br.read(r);
              break;
            }
            k += 16;
          } else {
            k += r;
            if (k > se) break;
            coef[k] = prog_extend(br, s) * (1 << al);
            ++k;
          }
        }
      } else {
        // Refinement scan: per-position state walks replaced by nonzero
        // bitmask jumps (VERDICT r1 weak #4 — the 653KB Y refinement scan
        // dominated 4K progressive decode at ~8 positions visited per
        // useful bit). tzcnt finds runs of untouched zeros in O(1);
        // correction bits for consecutive nonzeros batch into one read.
        int k = ss;
        uint64_t nzmask = nonzero_mask64(coef);
        const uint64_t band =
            (se == 63 ? ~0ull : ((1ull << (se + 1)) - 1)) & ~((1ull << ss) - 1);
        if (eobrun == 0) {
          while (k <= se) {
            if (br.count < 31) br.refill();
            int32_t s_val;
            int r;
            uint32_t fe = ref_lut.tab[(uint32_t)(br.bits >> kRefShift)];
            uint32_t kind = fe & 3;
            if (__builtin_expect(kind == 3, 1)) {  // insert / ZRL, sign fused
              int total = (fe >> 2) & 31;
              br.bits <<= total;
              br.count -= total;
              r = (fe >> 7) & 15;
              s_val = (fe & (1u << 12)) ? ((fe & (1u << 11)) ? p1 : m1) : 0;
            } else if (kind == 1) {  // EOB-run, length bits fused
              int total = (fe >> 2) & 31;
              br.bits <<= total;
              br.count -= total;
              eobrun = fe >> 16;
              break;
            } else {  // miss: long code / long EOB-run / invalid magnitude
              uint32_t e = ac_tab.lookup((uint32_t)(br.bits >> 48));
              int len = e & 0xFF;
              if (len == 0) return seg;
              br.consume(len);
              int rs = e >> 8;
              int s = rs & 0xF;
              r = rs >> 4;
              if (s == 0) {
                if (r != 15) {
                  eobrun = (int64_t)1 << r;
                  if (r) eobrun += br.read(r);
                  break;
                }
                s_val = 0;
              } else {
                if (s != 1) return seg;  // invalid refinement magnitude
                s_val = br.read(1) ? p1 : m1;
              }
            }
            // One-shot insertion: the target is the (r+1)-th ZERO at/after
            // k (pdep selects it in one instruction); every nonzero before
            // it consumes one correction bit, batched by refine_nonzeros.
            // Matches the spec walk exactly: corrections in ascending
            // position order, then the insert; if fewer than r+1 zeros
            // remain, all remaining nonzeros get corrections and the band
            // ends without an insert.
            uint64_t span = band & ~((1ull << k) - 1);
            uint64_t sel = _pdep_u64(1ull << r, ~nzmask & span);
            if (sel) {
              int target = __builtin_ctzll(sel);
              refine_nonzeros(br, coef, nzmask & span & (sel - 1), p1, m1);
              if (s_val) {
                coef[target] = s_val;
                nzmask |= sel;
              }
              k = target + 1;
            } else {
              refine_nonzeros(br, coef, nzmask & span, p1, m1);
              k = se + 1;
            }
          }
        }
        if (eobrun > 0) {
          if (k <= se)
            refine_nonzeros(br, coef, (nzmask & band) >> k << k, p1, m1);
          --eobrun;
        }
      }
    }
  }
  return -1;
}


// Assemble [total_blocks, 64] zigzag-order int32 stream (oracle contract)
// from per-component AC grids [bh, bw, 64] + compact DC grids [bh, bw].
// Parallel over MCU ranges; replaces a ~65ms/4K-frame numpy gather.
void jt_prog_assemble_stream(
    int32_t* const* ac_state, int32_t* const* dc_state,
    const int64_t* state_cols, const uint8_t* slot_comp,
    const uint8_t* slot_vi, const uint8_t* slot_hi, int32_t blocks_per_mcu,
    const uint8_t* comp_h, const uint8_t* comp_v, int32_t /*n_comp*/,
    int32_t mcus_x, int64_t n_mcus, int32_t* out, int32_t n_threads,
    const int64_t* gate_rows, int64_t gate_scale) {
  // Optional row gate: when the last (straggler) AC scan is still
  // decoding, assembly consumes MCU rows as that scan publishes its
  // per-block-row progress (gate_rows, same counter the row-pipelined
  // scans gate on; gate_scale = the gating component's block rows per
  // MCU row). Every OTHER scan must be complete before this is called.
  auto wait_row = [&](int64_t my) {
    if (!gate_rows) return;
    while (__atomic_load_n(gate_rows, __ATOMIC_ACQUIRE) <
           (my + 1) * gate_scale)
      std::this_thread::yield();
  };
  auto work = [&](int64_t lo, int64_t hi) {
    int64_t gated_my = -1;
    for (int64_t mcu = lo; mcu < hi; ++mcu) {
      int64_t my = mcu / mcus_x;
      int64_t mx = mcu % mcus_x;
      if (my != gated_my) {
        wait_row(my);
        gated_my = my;
      }
      int32_t* row = out + mcu * blocks_per_mcu * 64;
      for (int slot = 0; slot < blocks_per_mcu; ++slot, row += 64) {
        int c = slot_comp[slot];
        int64_t by = my * comp_v[c] + slot_vi[slot];
        int64_t bx = mx * comp_h[c] + slot_hi[slot];
        const int32_t* src = ac_state[c] + (by * state_cols[c] + bx) * 64;
        std::memcpy(row, src, 64 * sizeof(int32_t));
        row[0] = dc_state[c][by * state_cols[c] + bx];
      }
    }
  };
  int nt = (int)std::min<int64_t>(n_threads > 0 ? n_threads : 1, n_mcus);
  if (nt <= 1) {
    work(0, n_mcus);
    return;
  }
  pool_run(nt, [&](int t) {
    work(n_mcus * t / nt, n_mcus * (t + 1) / nt);
  });
}

// Assemble de-zigzagged int16 coefficient planes (the fast-path layout of
// jt_decode_scan_planes) from the progressive grids. Parallel over MCUs.
void jt_prog_assemble_planes(
    int32_t* const* ac_state, int32_t* const* dc_state,
    const int64_t* state_cols, const uint8_t* slot_comp,
    const uint8_t* slot_vi, const uint8_t* slot_hi, int32_t blocks_per_mcu,
    const uint8_t* comp_h, const uint8_t* comp_v, int32_t n_comp,
    int32_t mcus_x, int64_t n_mcus, int16_t* const* planes,
    const int64_t* plane_stride, int32_t n_threads) {
  auto work = [&](int64_t lo, int64_t hi) {
    int32_t zoff[8][64];
    for (int c = 0; c < n_comp; ++c) {
      int64_t st = plane_stride[c];
      for (int k = 0; k < 64; ++k)
        zoff[c][k] = (int32_t)(kZigRow[k] * st + kZigCol[k]);
    }
    for (int64_t mcu = lo; mcu < hi; ++mcu) {
      int64_t my = mcu / mcus_x;
      int64_t mx = mcu % mcus_x;
      for (int slot = 0; slot < blocks_per_mcu; ++slot) {
        int c = slot_comp[slot];
        int64_t by = my * comp_v[c] + slot_vi[slot];
        int64_t bx = mx * comp_h[c] + slot_hi[slot];
        const int32_t* src = ac_state[c] + (by * state_cols[c] + bx) * 64;
        int16_t* dst =
            planes[c] + by * 8 * plane_stride[c] + bx * 8;
        for (int r = 0; r < 8; ++r)
          std::memset(dst + r * plane_stride[c], 0, 8 * sizeof(int16_t));
        dst[0] = (int16_t)dc_state[c][by * state_cols[c] + bx];
        for (int k = 1; k < 64; ++k)
          if (src[k]) dst[zoff[c][k]] = (int16_t)src[k];
      }
    }
  };
  int nt = (int)std::min<int64_t>(n_threads > 0 ? n_threads : 1, n_mcus);
  if (nt <= 1) {
    work(0, n_mcus);
    return;
  }
  pool_run(nt, [&](int t) {
    work(n_mcus * t / nt, n_mcus * (t + 1) / nt);
  });
}



// Arithmetic (SOF9) scan -> de-zigzagged int16 planes, thread-parallel over
// restart segments (same contract/prezero modes as jt_decode_scan_planes).
int64_t jt_decode_arith_scan_planes(
    const uint8_t* data, int64_t /*n_bytes*/, const int64_t* seg_start,
    const int64_t* seg_end, const int64_t* seg_mcu_start,
    const int64_t* seg_mcu_count, int64_t n_segs, const uint8_t* slot_comp,
    const uint8_t* slot_vi, const uint8_t* slot_hi, int32_t blocks_per_mcu,
    const uint8_t* comp_dc_id, const uint8_t* comp_ac_id,
    const uint8_t* comp_h, const uint8_t* comp_v, int32_t n_comp,
    int32_t mcus_x, const uint8_t* dc_L, const uint8_t* dc_U,
    const uint8_t* ac_K, int16_t* const* planes, const int64_t* plane_stride,
    const int64_t* plane_rows, int32_t prezero, int32_t n_threads) {
  std::atomic<int64_t> first_error(-1);
  int32_t zoff[8][64];
  for (int c = 0; c < n_comp; ++c) {
    int64_t st = plane_stride[c];
    for (int k = 0; k < 64; ++k)
      zoff[c][k] = (int32_t)(kZigRow[k] * st + kZigCol[k]);
  }
  // Work stealing (same scheduler as the Huffman plane path): QM segment
  // cost skews heavily with content, so threads pull from a shared
  // counter instead of fixed contiguous slices.
  std::atomic<int64_t> next_seg(0);
  auto work = [&](int64_t /*lo*/, int64_t /*hi*/) {
    ArithStats stats;
    for (int64_t sgi; (sgi = next_seg.fetch_add(1)) < n_segs;) {
      QMDecoder dec(data + seg_start[sgi], seg_end[sgi] - seg_start[sgi]);
      stats.reset();
      int64_t mcu = seg_mcu_start[sgi];
      for (int64_t m = 0; m < seg_mcu_count[sgi]; ++m, ++mcu) {
        int64_t my = mcu / mcus_x;
        int64_t mx = mcu % mcus_x;
        for (int slot = 0; slot < blocks_per_mcu; ++slot) {
          int ci = slot_comp[slot];
          int64_t st = plane_stride[ci];
          int64_t by = my * comp_v[ci] + slot_vi[slot];
          int64_t bx = mx * comp_h[ci] + slot_hi[slot];
          int16_t* dst = planes[ci] + by * 8 * st + bx * 8;
          if (prezero == 1)
            for (int r = 0; r < 8; ++r)
              std::memset(dst + r * st, 0, 8 * sizeof(int16_t));
          int di = comp_dc_id[ci], ai = comp_ac_id[ci];
          int err = qm_decode_dc(dec, stats, di, ci, dc_L[di], dc_U[di]);
          if (!err) {
            dst[0] = (int16_t)stats.last_dc[ci];
            const int32_t* zf = zoff[ci];
            err = qm_decode_ac(dec, stats, ai, ac_K[ai],
                               [&](int k, int v) {
                                 dst[zf[k]] = (int16_t)v;
                               });
          }
          if (__builtin_expect(err != 0, 0)) {
            int64_t expect = -1;
            first_error.compare_exchange_strong(expect, sgi);
            return;
          }
        }
      }
    }
  };
  int nt = (int)std::min<int64_t>(n_threads > 0 ? n_threads : 1, n_segs);
  if (nt <= 1) {
    if (prezero == 2) {
      PlaneJob zj{};
      zj.n_comp = n_comp;
      zj.planes = planes;
      zj.plane_stride = plane_stride;
      zj.plane_rows = plane_rows;
      zero_plane_slice(zj, 0, 1);
    }
    work(0, n_segs);
    return first_error.load();
  }
  std::atomic<int> zeroed(0);
  pool_run(nt, [&](int t) {
    if (prezero == 2) {
      PlaneJob zj{};
      zj.n_comp = n_comp;
      zj.planes = planes;
      zj.plane_stride = plane_stride;
      zj.plane_rows = plane_rows;
      zero_plane_slice(zj, t, nt);
      zeroed.fetch_add(1, std::memory_order_acq_rel);
      while (zeroed.load(std::memory_order_acquire) < nt)
        std::this_thread::yield();
    }
    work(n_segs * t / nt, n_segs * (t + 1) / nt);
  });
  return first_error.load();
}

// Arithmetic scan -> [total_blocks, 64] int32 zigzag stream (pre-zeroed by
// the caller), the oracle contract.
int64_t jt_decode_arith_scan(
    const uint8_t* data, int64_t /*n_bytes*/, const int64_t* seg_start,
    const int64_t* seg_end, const int64_t* seg_mcu_start,
    const int64_t* seg_mcu_count, int64_t n_segs, const uint8_t* slot_comp,
    int32_t blocks_per_mcu, const uint8_t* comp_dc_id,
    const uint8_t* comp_ac_id, int32_t n_comp, const uint8_t* dc_L,
    const uint8_t* dc_U, const uint8_t* ac_K, int32_t* out,
    int32_t n_threads) {
  (void)n_comp;
  std::atomic<int64_t> first_error(-1);
  auto work = [&](int64_t lo, int64_t hi) {
    ArithStats stats;
    for (int64_t sgi = lo; sgi < hi; ++sgi) {
      QMDecoder dec(data + seg_start[sgi], seg_end[sgi] - seg_start[sgi]);
      stats.reset();
      int32_t* row = out + seg_mcu_start[sgi] * blocks_per_mcu * 64;
      for (int64_t m = 0; m < seg_mcu_count[sgi]; ++m) {
        for (int slot = 0; slot < blocks_per_mcu; ++slot, row += 64) {
          int ci = slot_comp[slot];
          int di = comp_dc_id[ci], ai = comp_ac_id[ci];
          int err = qm_decode_dc(dec, stats, di, ci, dc_L[di], dc_U[di]);
          if (!err) {
            row[0] = stats.last_dc[ci];
            err = qm_decode_ac(dec, stats, ai, ac_K[ai],
                               [&](int k, int v) { row[k] = v; });
          }
          if (__builtin_expect(err != 0, 0)) {
            int64_t expect = -1;
            first_error.compare_exchange_strong(expect, sgi);
            return;
          }
        }
      }
    }
  };
  int nt = (int)std::min<int64_t>(n_threads > 0 ? n_threads : 1, n_segs);
  if (nt <= 1) {
    work(0, n_segs);
    return first_error.load();
  }
  pool_run(nt, [&](int t) {
    work(n_segs * t / nt, n_segs * (t + 1) / nt);
  });
  return first_error.load();
}


// Progressive arithmetic (SOF10) scan decode — C++ twins of
// jpeg_tpu.entropy.arith._prog_dc_scan_arith/_prog_ac_scan_arith
// (equivalence-tested). State layouts match the Huffman progressive path:
// compact int32 DC grids + [bh, bw, 64] zigzag AC grids, so the existing
// parallel assembly (jt_prog_assemble_*) applies unchanged.

// DC scan (ss == 0). Returns -1 ok, >= 0 first bad segment.
int64_t jt_decode_arith_prog_dc(
    const uint8_t* data, const int64_t* seg_start, const int64_t* seg_end,
    int64_t n_segs, int64_t restart_units, int32_t ah, int32_t al,
    int32_t n_scan_comps, const int32_t* scan_comp_h,
    const int32_t* scan_comp_v, int32_t* const* state,
    const int64_t* state_cols, const int32_t* scan_dc_ids,
    const uint8_t* dc_L, const uint8_t* dc_U, int32_t mcus_x,
    int64_t n_units, int32_t interleaved, const int64_t* comp_bw) {
  int64_t unit = 0;
  for (int64_t seg = 0; seg < n_segs && unit < n_units; ++seg) {
    QMDecoder dec(data + seg_start[seg], seg_end[seg] - seg_start[seg]);
    ArithStats stats;
    stats.reset();
    for (int64_t u = 0; u < restart_units && unit < n_units; ++u, ++unit) {
      if (interleaved) {
        int64_t my = unit / mcus_x;
        int64_t mx = unit % mcus_x;
        for (int s = 0; s < n_scan_comps; ++s) {
          int h = scan_comp_h[s], v = scan_comp_v[s];
          int tid = scan_dc_ids[s];
          for (int vi = 0; vi < v; ++vi) {
            for (int hi = 0; hi < h; ++hi) {
              int32_t* coef =
                  state[s] + (my * v + vi) * state_cols[s] + mx * h + hi;
              if (ah) {
                if (dec.decode_fixed()) *coef |= 1 << al;
              } else {
                if (qm_decode_dc(dec, stats, tid, s, dc_L[tid], dc_U[tid]))
                  return seg;
                *coef = stats.last_dc[s] << al;
              }
            }
          }
        }
      } else {
        int64_t by = unit / comp_bw[0];
        int64_t bx = unit % comp_bw[0];
        int32_t* coef = state[0] + by * state_cols[0] + bx;
        int tid = scan_dc_ids[0];
        if (ah) {
          if (dec.decode_fixed()) *coef |= 1 << al;
        } else {
          if (qm_decode_dc(dec, stats, tid, 0, dc_L[tid], dc_U[tid]))
            return seg;
          *coef = stats.last_dc[0] << al;
        }
      }
    }
  }
  return -1;
}

// AC scan (single component). Returns -1 ok, >= 0 first bad segment.
int64_t jt_decode_arith_prog_ac(
    const uint8_t* data, const int64_t* seg_start, const int64_t* seg_end,
    int64_t n_segs, int64_t restart_blocks, int32_t ss, int32_t se,
    int32_t ah, int32_t al, int32_t kx, int32_t* state, int64_t state_cols,
    int64_t bw, int64_t n_blocks) {
  const int32_t p1 = 1 << al;
  const int32_t m1_ = -p1;
  int64_t bi = 0;
  for (int64_t seg = 0; seg < n_segs && bi < n_blocks; ++seg) {
    QMDecoder dec(data + seg_start[seg], seg_end[seg] - seg_start[seg]);
    ArithStats stats;
    stats.reset();
    uint8_t* st_ac = stats.ac[0];
    for (int64_t u = 0; u < restart_blocks && bi < n_blocks; ++u, ++bi) {
      int64_t by = bi / bw;
      int64_t bx = bi % bw;
      int32_t* blk = state + (by * state_cols + bx) * 64;
      if (ah == 0) {
        int k = ss;
        while (k <= se) {
          uint8_t* st = st_ac + 3 * (k - 1);
          if (dec.decode(st)) break;  // EOB
          while (dec.decode(st + 1) == 0) {
            st += 3;
            if (++k > se) return seg;
          }
          int sign = dec.decode_fixed();
          st += 2;
          int m;
          if (dec.decode(st) == 0) {
            m = 0;
          } else if (dec.decode(st) == 0) {
            m = 1;
          } else {
            m = 2;
            st = st_ac + (k <= kx ? 189 : 217);
            while (dec.decode(st)) {
              if ((m <<= 1) == 0x8000) return seg;
              ++st;
            }
          }
          int v = m;
          st += 14;
          while (m > 1) {
            m >>= 1;
            if (dec.decode(st)) v |= m;
          }
          v += 1;
          blk[k] = (sign ? -v : v) * p1;
          ++k;
        }
      } else {
        int kex = se;
        while (kex > 0 && blk[kex] == 0) --kex;
        int k = ss;
        while (k <= se) {
          uint8_t* st = st_ac + 3 * (k - 1);
          if (k > kex && dec.decode(st)) break;  // EOB
          for (;;) {
            int32_t c = blk[k];
            if (c != 0) {
              if (dec.decode(st + 2)) blk[k] = c + (c < 0 ? m1_ : p1);
              break;
            }
            if (dec.decode(st + 1)) {
              blk[k] = dec.decode_fixed() ? m1_ : p1;
              break;
            }
            st += 3;
            if (++k > se) return seg;
          }
          ++k;
        }
      }
    }
  }
  return -1;
}

// Byte-unstuffing + restart-segment scan in one pass.
// Parity: reference unstuff loop (src/jpeg/mod.rs:371-385) + the RST
// handling it lacks. Writes unstuffed bytes to `out` (same size or smaller
// than input), segment bounds to seg_start/seg_end (capacity max_segs).
// Returns number of segments. `consumed` gets the raw length scanned
// (up to but excluding the terminating marker).
int64_t jt_unstuff_scan(const uint8_t* data, int64_t n, uint8_t* out,
                        int64_t* out_len, int64_t* seg_start,
                        int64_t* seg_end, int64_t max_segs,
                        int64_t* consumed) {
  int64_t o = 0;
  int64_t n_segs = 0;
  int64_t cur_start = 0;
  int64_t i = 0;
  for (; i < n; ++i) {
    uint8_t b = data[i];
    if (__builtin_expect(b != 0xFF, 1)) {
      out[o++] = b;
      continue;
    }
    if (i + 1 >= n) break;
    uint8_t nxt = data[i + 1];
    if (nxt == 0x00) {  // stuffed data byte
      out[o++] = 0xFF;
      ++i;
      continue;
    }
    if (nxt >= 0xD0 && nxt <= 0xD7) {  // RSTn: close segment
      if (n_segs < max_segs) {
        seg_start[n_segs] = cur_start;
        seg_end[n_segs] = o;
        ++n_segs;
      }
      cur_start = o;
      ++i;
      continue;
    }
    break;  // real marker terminates the scan
  }
  if (n_segs < max_segs) {
    seg_start[n_segs] = cur_start;
    seg_end[n_segs] = o;
    ++n_segs;
  }
  *out_len = o;
  *consumed = i;
  return n_segs;
}

}  // extern "C"
