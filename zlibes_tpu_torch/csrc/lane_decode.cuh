// What the per-lane Huffman decode kernels share (decode_turbo in
// turbo_kernels.cu, decode_wide in wide_kernels.cu, decode_tokens in
// inflate_kernels.cu): asynchronous copies, the staging of a block's lane
// windows out of the stream, the packing of table entries for a walk that
// keeps its stream bits in registers, the layout and lookup of the
// two-level tables that wide_decode_tables builds, and their flattening
// into the one-level roots of a walk's fast step.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lane_decode {

// ------------------------------------------------------------ async copies
// cp.async: global -> shared without a register in between; a thread's
// copies are complete after cp_async_wait<N> (all but its N newest groups)
// and visible to the block after the barrier that follows.

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kNewest>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kNewest) : "memory");
}

// ---------------------------------------------------------------- windows
// The window stage of both decoders (what lane_windows_kernel computes into
// device memory, here straight into shared memory):
//     s_win[r * pitch + w] = words[start_w[r] + w]   for w < width,
// 0 for an index outside [0, nwords).  A warp takes whole rows, its lanes
// neighbouring words of the row, so a warp instruction copies one run of
// the stream (a full 128-byte line where the row is aligned); the copies
// are 4 bytes wide because a window starts at any word.  Neighbouring rows
// overlap in the stream, so most of these reads are served by L1 and L2.
// Rows have the pitch the caller gives (odd, so that lanes reading their own
// word i fall on different banks).  Ends with a commit: the caller waits
// (cp_async_wait<0>) and synchronises the block.

__device__ __forceinline__ void stage_windows(
    const int32_t* __restrict__ words, int64_t nwords,
    const int32_t* __restrict__ start_w, int rows, int width, int pitch,
    int32_t* s_win, int tid, int nthreads) {
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  for (int r = warp; r < rows; r += nwarps) {
    const int64_t first = __ldg(start_w + r);
    for (int w = lane; w < width; w += 32) {
      const int64_t idx = first + w;
      int32_t* dst = s_win + r * pitch + w;
      if (idx >= 0 && idx < nwords)
        cp_async4(dst, words + idx);
      else
        *dst = 0;
    }
  }
  cp_async_commit();
}

// ------------------------------------------------------- repacked entries
// Table entries as the host builds them (ops/turbo_kernel.py
// turbo_decode_tables, ops/wide_kernel.py wide_decode_tables):
//   litlen: codelen(4b) | kind(2b @4) | extra#(3b @6) | base(9b @9)
//   dist:   codelen(4b) | extra#(4b @4) | base(15b @8)
// are repacked while they are staged, so that the bits an entry consumes are
// its low five bits (a funnel shift takes its count modulo 32 and needs no
// mask) and every other field is one shift away.

constexpr int kKindEob = 1, kKindLen = 2, kKindInvalid = 3;

// repacked litlen entry
constexpr int kEUsedMask = 31;      // bits 0..4: code + extra bits (<= 22)
constexpr int kELnShift = 5;        // bits 5..8: code length
constexpr int kEEbShift = 9;        // bits 9..11: extra bits
constexpr int kEBaseShift = 12;     // bits 12..20: literal byte / length base
constexpr int kELen = 1 << 21;      // a length
constexpr int kEEob = 1 << 22;      // end of block
constexpr int kEBad = 1 << 23;      // no code, or an invalid symbol
constexpr int kELitShift = 27;      // bits 27..31: the low field again, for a
                                    // literal; 0 for any other entry
// repacked distance entry: the table's 23 bits; bits consumed (<= 30) in
// bits 26..30; bit 31 when the entry is invalid or its distance can pass
// the profile's largest, which reads as "32 bits more" in the consumed field
constexpr int kDtMask = (1 << 23) - 1;
constexpr int kDUsedShift = 26;
constexpr int kDSlow = (int)0x80000000u;

__device__ __forceinline__ int repack_lt(int e) {
  const int ln = e & 15, kind = (e >> 4) & 3, eb = (e >> 6) & 7;
  const int base = (e >> 9) & 511;
  const int out = (ln + eb) | (ln << kELnShift) | (eb << kEEbShift) |
                  (base << kEBaseShift);
  if (ln == 0 || kind == kKindInvalid) return out | kEBad;
  if (kind == kKindEob) return out | kEEob;
  if (kind == kKindLen) return out | kELen;
  return out | ((ln + eb) << kELitShift);
}

__device__ __forceinline__ int repack_dt(int d, int max_dist) {
  d &= kDtMask;
  const int dln = d & 15, deb = (d >> 4) & 15, base = (d >> 8) & 0x7FFF;
  const bool maybe_bad = dln == 0 || base + (1 << deb) - 1 > max_dist;
  return d | ((dln + deb + (maybe_bad ? 32 : 0)) << kDUsedShift);
}

// the distance of a length token whose distance code starts at y's bit 0
__device__ __forceinline__ int token_dist(int de, uint32_t y) {
  const int dln = de & 15, deb = (de >> 4) & 15;
  return ((de >> 8) & 0x7FFF) + (int)((y >> dln) & ((1u << deb) - 1u));
}

// bits [pos, pos + len) of x, len < 32: one bit-field extract
__device__ __forceinline__ uint32_t bits_at(uint32_t x, int pos, int len) {
  uint32_t out;
  asm("bfe.u32 %0, %1, %2, %3;" : "=r"(out) : "r"(x), "r"(pos), "r"(len));
  return out;
}

// ------------------------------------------------------ two-level tables
// One block row of wide_decode_tables (ops/wide_kernel.py): a litlen root
// of 2^9 entries and its sub-tables (LL_W entries), a distance root of 2^6
// entries and its sub-tables from D_SUB_OFF (D_W entries).  A root entry
// with kSubFlag points to a sub-table: base in bits 9.. (litlen) or 8..
// (distance), index width in bits 0..3 (litlen) or 24..27 (distance).

constexpr int kLlRootBits = 9;      // LL_ROOT_BITS
constexpr int kLlRoot = 1 << kLlRootBits;
constexpr int kLlSub = 512;         // LL_SUB
constexpr int kLlW = kLlRoot + kLlSub;
constexpr int kDRootBits = 6;       // D_ROOT_BITS
constexpr int kDRoot = 1 << kDRootBits;
constexpr int kDSubOff = 128;       // D_SUB_OFF
constexpr int kDW = kDSubOff + 640; // D_W
constexpr int kSubFlag = 1 << 30;

// an entry of a table in shared memory (kGlobal false) or in global memory,
// read through the read-only path (kGlobal true)
template <bool kGlobal>
__device__ __forceinline__ int table_entry(const int32_t* t, int i) {
  if constexpr (kGlobal) return __ldg(t + i);
  return t[i];
}

// the litlen entry of the plain two-level lookup at the view x
template <bool kGlobal = false>
__device__ __forceinline__ int lookup_ll(const int32_t* lt, uint32_t x) {
  const int e1 = table_entry<kGlobal>(lt, x & (kLlRoot - 1));
  if (!(e1 & kSubFlag)) return e1;
  const int subw = min(e1 & 15, 6);
  const int sidx = ((e1 >> 9) & 511) +
                   (int)((x >> kLlRootBits) & ((1u << subw) - 1u));
  return table_entry<kGlobal>(lt, kLlRoot + min(sidx, kLlSub - 1));
}

// the distance entry of the plain two-level lookup at the view y
template <bool kGlobal = false>
__device__ __forceinline__ int lookup_d(const int32_t* dt, uint32_t y) {
  const int d1 = table_entry<kGlobal>(dt, y & (kDRoot - 1));
  if (!(d1 & kSubFlag)) return d1;
  const int dsw = min((d1 >> 24) & 15, 9);
  const int dsidx = ((d1 >> 8) & 1023) +
                    (int)((y >> kDRootBits) & ((1u << dsw) - 1u));
  return table_entry<kGlobal>(dt, kDSubOff + min(dsidx, 639));
}

// ------------------------------------------------------- one-level roots
// A two-level row flattened into a one-level root of more bits than its
// own root, whose entries the fast step of a walk indexes with no branch.

// Whether every bit pattern whose low `bits` bits are i finds the same
// entry in a two-level table (root entry e1 at i's root bits, a pointer to
// a sub-table of 2^subw entries from index base of sub, indices clipped to
// cap): then *e is that entry.  With all of the sub-table's index bits in i
// the entry is simply looked up.  With some missing, the entry found with
// zeros for them stands for all of them when its code is no longer than
// `bits`: wide_decode_tables (ops/wide_kernel.py) repeats an entry of code
// length n every 2^(n - root_bits) sub-table slots.  An empty slot (code
// length 0) or a longer code leaves the index to the two-level lookup.
__device__ __forceinline__ bool flat_entry(const int32_t* sub, int e1,
                                           int subw, int base, int cap, int i,
                                           int root_bits, int bits, int* e) {
  const int have = min(subw, bits - root_bits);
  const int low = base + ((i >> root_bits) & ((1 << have) - 1));
  *e = sub[min(low, cap)];
  const int ln = *e & 15;
  return subw == have || (ln != 0 && ln <= bits);
}

// entry i of the repacked one-level litlen root of `bits` bits of the row
// lt: kEBad where a longer code (or none) decides
__device__ __forceinline__ int flat_lt_entry(const int32_t* lt, int i,
                                             int bits) {
  const int e1 = lt[i & (kLlRoot - 1)];
  if (!(e1 & kSubFlag)) return repack_lt(e1);
  int e;
  return flat_entry(lt + kLlRoot, e1, min(e1 & 15, 6), (e1 >> 9) & 511,
                    kLlSub - 1, i, kLlRootBits, bits, &e)
             ? repack_lt(e) : kEBad;
}

// entry i of the repacked one-level distance root of `bits` bits of the row
// dt: kDSlow where a longer code (or none) decides
__device__ __forceinline__ int flat_dt_entry(const int32_t* dt, int i,
                                             int bits, int max_dist) {
  const int d1 = dt[i & (kDRoot - 1)];
  if (!(d1 & kSubFlag)) return repack_dt(d1, max_dist);
  int d;
  return flat_entry(dt + kDSubOff, d1, min((d1 >> 24) & 15, 9),
                    (d1 >> 8) & 1023, 639, i, kDRootBits, bits, &d)
             ? repack_dt(d, max_dist) : kDSlow;
}

}  // namespace lane_decode
