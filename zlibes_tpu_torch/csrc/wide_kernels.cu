// Default-profile (wide) inflate kernels for Hopper (sm_90a).
//
// One kernel per stage of zlibes_tpu_torch/ops/wide_kernel.py, each with a
// plain extern "C" launcher that takes device pointers and a CUDA stream,
// launches on that stream, and returns cudaGetLastError().  The Python
// wrappers check shapes, types and devices and allocate every output and
// scratch array; the plain PyTorch versions beside them define the same
// results.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -c -Xcompiler -fPIC -o wide_kernels.o wide_kernels.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_decode.cuh"

namespace {

using namespace lane_decode;

constexpr int kSub = 128;           // SUB: bytes per lane / sub-span
constexpr int kWindow = 32768;      // RFC 1951 window
constexpr int kMatchBit = 1 << 25;  // TOK_MATCH_BIT
constexpr int kTokensPad = 256;     // TOKENS_PAD: slots per sub-span
constexpr int kFlag = 1 << 30;      // resolved-byte flag
constexpr int kTile = 4096;         // resolve tile (bytes)

// ---------------------------------------------------------------- decode
// One thread per lane, 32 lanes per block, the walk in one warp; a block's
// lanes lie in one block row (LPB is a multiple of 128), whose tables it
// stages.
//
// A lane is a serial chain, and a warp that runs alone gets one
// instruction out in four to six cycles: the kernel's time is the longest
// lane's steps times what a step costs its warp.  The walk is decode_turbo's
// (turbo_kernels.cu), carried over to tables of 15-bit codes and distances
// up to 32 KiB:
//
//  * the block's 32 windows come into shared memory straight from the
//    stream (stage_windows in lane_decode.cuh), rows at the odd pitch
//    sw + 1; their width differs from stream to stream, so the area is
//    dynamic shared memory;
//  * the row's two-level tables are staged as they are (7 KB, 16-byte
//    asynchronous copies) and then flattened into one-level roots that the
//    fast step indexes with no branch: 11 bits of litlen root (8 KB), 8 bits
//    of distance root (1 KB).  A root entry that holds a code decides every
//    index that ends in its bits: it is repacked once and stored for all of
//    them.  Root entries that point to a sub-table are few but lie scattered
//    (a warp's 32 roots hold one or two, and a warp pays for a branch that
//    any of its lanes takes), so the first pass only lists them and a
//    second pass looks their indices up side by side, one thread an index.
//    An index whose entry more bits would decide (a code longer than the
//    root) is marked so and leaves the fast step; on zlib's level-6 output
//    that is under 0.5% of the tokens and 1.5% of the lengths.  Flattening
//    index by index, every warp through the pointers' branch, took most of
//    the staging time, which every one of the row's 32 blocks pays;
//  * entries are repacked as in decode_turbo: the bits consumed are the low
//    five, a funnel shift's count; a distance entry that is invalid, slow or
//    can pass 32768 reads as "32 bits more";
//  * a lane keeps the 96 stream bits at its position in three registers and
//    the window's next words behind them; a token can take 48 bits, so a
//    step of 32 bits or more leaves the fast step (a handful of tokens in a
//    million) and the view needs no 64-bit arithmetic;
//  * a step takes two literals when the entry behind a literal is a literal
//    too and a second slot is free; the second start is the first's + 1;
//  * the next step's lookup goes out before this step is judged.  The
//    running output position (starts, the before-the-block check) depends on
//    the values, not on the next index, so it stays off the lookup chain; a
//    distance that reaches before the block leaves the fast step before
//    anything is stored or moved;
//  * a lane's last token stays in the fast step when it ends at or before
//    the lane's end: lanes end at different steps, so a rare case there
//    would be paid in most steps of a warp;
//  * every rare case (end of block, an invalid or a long code, a suspect
//    distance, a token that ends past the lane's end, 32 bits or more) takes
//    one token through the two-level tables with the plain version's checks
//    in its order, and sets the registers up again.
//
// Tokens and starts stay (T, L): a warp's stores land on neighbouring
// addresses.  The last token and its start (meta rows 4, 5) are read back
// from the lane's own last slot when the walk is over.

constexpr int kDecodeLanes = 32;     // lanes per block
constexpr int kDecodeThreads = 128;  // all stage, warp 0 walks
constexpr int kLlFastBits = 11;      // one-level litlen root of the fast step
constexpr int kLlFast = 1 << kLlFastBits;
constexpr int kDFastBits = 8;        // one-level distance root
constexpr int kDFast = 1 << kDFastBits;

__global__ void __launch_bounds__(kDecodeThreads)
decode_wide_kernel(const int32_t* __restrict__ words, int64_t nwords,
                   const int32_t* __restrict__ start_w, int sw,
                   const int32_t* __restrict__ bit0,
                   const int32_t* __restrict__ endb,
                   const int32_t* __restrict__ base,
                   const int32_t* __restrict__ lt_g,
                   const int32_t* __restrict__ dt_g, int lanes, int lpb,
                   int max_tokens, int32_t* __restrict__ tokens,
                   int32_t* __restrict__ starts, int32_t* __restrict__ meta) {
  extern __shared__ int32_t s_win[];  // 32 rows of sw + 1 words
  __shared__ __align__(16) int32_t s_lt[kLlW];  // the row's two-level tables
  __shared__ __align__(16) int32_t s_dt[kDW];
  __shared__ int32_t s_lf[kLlFast];   // their flat, repacked roots
  __shared__ int32_t s_df[kDFast];
  __shared__ int16_t s_sub[kLlRoot + kDRoot];  // roots that are pointers
  __shared__ int s_nsub;
  const int tid = threadIdx.x;
  const int first = blockIdx.x * kDecodeLanes;
  const int here = min(kDecodeLanes, lanes - first);  // lanes of this block
  const int pitch = sw + 1;
  const int64_t row = first / lpb;
  if (tid == 0) s_nsub = 0;

  // the row's tables: 16-byte copies (rows are 4 KB and 3 KB, aligned);
  // then the windows, which are not needed before the walk
  for (int i = tid; i < kLlW / 4; i += kDecodeThreads)
    cp_async16(s_lt + 4 * i, lt_g + row * kLlW + 4 * i);
  for (int i = tid; i < kDW / 4; i += kDecodeThreads)
    cp_async16(s_dt + 4 * i, dt_g + row * kDW + 4 * i);
  cp_async_commit();
  stage_windows(words, nwords, start_w + first, here, sw, pitch, s_win, tid,
                kDecodeThreads);
  cp_async_wait<1>();
  __syncthreads();
  // flatten, first pass: a root entry that is no sub-table pointer decides
  // every index that ends in its root bits, so it is repacked once and
  // stored for all of them.  Pointers are few and scattered (a warp's 32
  // roots hold one or two), so they are only listed here
  for (int r = tid; r < kLlRoot + kDRoot; r += kDecodeThreads) {
    const bool is_d = r >= kLlRoot;
    const int e1 = is_d ? s_dt[r - kLlRoot] : s_lt[r];
    if (e1 & kSubFlag) {
      s_sub[atomicAdd(&s_nsub, 1)] = (int16_t)r;
    } else if (is_d) {
      const int d = repack_dt(e1, kWindow);
#pragma unroll
      for (int i = r - kLlRoot; i < kDFast; i += kDRoot) s_df[i] = d;
    } else {
      const int e = repack_lt(e1);
#pragma unroll
      for (int i = r; i < kLlFast; i += kLlRoot) s_lf[i] = e;
    }
  }
  __syncthreads();
  // second pass: behind a pointer each index is looked up on its own, one
  // thread an index, the listed pointers side by side
  constexpr int kLlRep = kLlFast / kLlRoot, kDRep = kDFast / kDRoot;
  static_assert(kLlRep == kDRep, "one replica count for both tables");
  for (int j = tid; j < s_nsub * kLlRep; j += kDecodeThreads) {
    const int r = s_sub[j / kLlRep], h = j % kLlRep;
    int sub;
    if (r >= kLlRoot) {
      const int i = r - kLlRoot + h * kDRoot;
      const int d1 = s_dt[r - kLlRoot];
      s_df[i] =
          flat_entry(s_dt + kDSubOff, d1, min((d1 >> 24) & 15, 9),
                     (d1 >> 8) & 1023, 639, i, kDRootBits, kDFastBits, &sub)
              ? repack_dt(sub, kWindow) : kDSlow;
    } else {
      const int i = r + h * kLlRoot;
      const int e1 = s_lt[r];
      s_lf[i] =
          flat_entry(s_lt + kLlRoot, e1, min(e1 & 15, 6), (e1 >> 9) & 511,
                     kLlSub - 1, i, kLlRootBits, kLlFastBits, &sub)
              ? repack_lt(sub) : kEBad;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (tid >= here) return;

  const int l = first + tid;
  const int32_t* w = s_win + tid * pitch;
  const unsigned last_w = (unsigned)(sw - 1);
  // word i of the lane's window; an index past it (or before it) reads its
  // last word, as the plain version's clamp does
  auto window_word = [&](int i) -> uint32_t {
    return (uint32_t)w[min((unsigned)i, last_w)];
  };
  // the lane's sub-span offset in its block: no distance reaches further
  const int span0 = (l % lpb) * kSub;
  int pos = bit0[l];
  const int end = endb[l];
  int outpos = base[l];
  bool active = pos < end;
  int err = 0;
  int count = 0;
  if (active && max_tokens > 0) {
    uint32_t x0, x1, x2;      // the 96 stream bits at pos, LSB-first
    uint32_t r1, r2, r3, p0;  // window words: x1 = r1:r2 >> s, x2 = r2:r3 >> s
    int wq;                   // index of the word after p0 (sw - 1 at most)
    int s;                    // pos & 31
    int e;                    // the flat entry of the token at pos
    // the registers of a walk that stands at pos
    auto stand = [&]() {
      const int wi = pos >> 5;
      s = pos & 31;
      const uint32_t r0 = window_word(wi);
      r1 = window_word(wi + 1);
      r2 = window_word(wi + 2);
      r3 = window_word(wi + 3);
      p0 = window_word(wi + 4);
      wq = (int)min((unsigned)(wi + 5), last_w);
      x0 = __funnelshift_r(r0, r1, s);
      x1 = __funnelshift_r(r1, r2, s);
      x2 = __funnelshift_r(r2, r3, s);
      e = s_lf[x0 & (kLlFast - 1)];
    };
    stand();
    int slot = l;  // of the next token, in tokens and in starts
    for (;;) {
      const int k1 = e & kEUsedMask;
      // the bits behind the first token
      const uint32_t y0 = __funnelshift_r(x0, x1, e);
      const uint32_t y1 = __funnelshift_r(x1, x2, e);
      // both lookups there go out for every token, with no branch: the
      // distance entry counts behind a length (a clamped shift by 32 leaves
      // 0), the litlen entry behind a literal when it is a literal too and a
      // second slot is free
      const int de = s_df[y0 & (kDFast - 1)];
      const int e2 = s_lf[y0 & (kLlFast - 1)];
      const bool is_len = (e & kELen) != 0;
      const int dshift = is_len ? kDUsedShift : 32;
      const int lit_mask =
          ((uint32_t)e >> kELitShift) != 0 && count + 2 <= max_tokens
              ? kEUsedMask : 0;
      const int k2 = (int)((uint32_t)e2 >> kELitShift) & lit_mask;
      const int more = (int)__funnelshift_rc((uint32_t)de, 0u, dshift) | k2;
      const uint32_t nx0 = __funnelshift_r(y0, y1, more);
      // the next step's lookup goes out before this step is judged
      const int e_next = s_lf[nx0 & (kLlFast - 1)];
      const int used = k1 + more;
      const int val = ((e >> kEBaseShift) & 511) +
                      (is_len ? (int)bits_at(x0, (e >> kELnShift) & 15,
                                             (e >> kEEbShift) & 7)
                              : 0);
      const int dist = ((de >> 8) & 0x7FFF) +
                       (int)bits_at(y0, de & 15, (de >> 4) & 15);
      if ((e & (kEEob | kEBad)) ||
          (uint32_t)(used - 1) >= (uint32_t)min(end - pos, 31) ||
          (is_len && dist > span0 + outpos)) {
        // rare: one token through the two-level tables, every check
        const int er = lookup_ll(s_lt, x0);
        const int ln = er & 15, kind = (er >> 4) & 3, eb = (er >> 6) & 7;
        const bool rlen = kind == kKindLen;
        const int rval =
            ((er >> 9) & 511) + (rlen ? (int)bits_at(x0, ln, eb) : 0);
        const uint32_t yr = __funnelshift_r(x0, x1, ln + eb);
        const int dr = lookup_d(s_dt, yr);
        const int dln = dr & 15, deb = (dr >> 4) & 15;
        const int rdist = token_dist(dr, yr);
        const int newpos = pos + ln + eb + (rlen ? dln + deb : 0);
        if (ln == 0 || kind == kKindInvalid ||
            (rlen && (dln == 0 || rdist > kWindow ||
                      rdist > span0 + outpos)) ||
            newpos > end) {
          err = 1;
          active = false;
          break;
        }
        pos = newpos;
        if (kind == kKindEob) {
          active = false;
          break;
        }
        tokens[slot] = rlen ? (rval | (rdist << 9) | kMatchBit) : rval;
        starts[slot] = outpos;
        slot += lanes;
        outpos += rlen ? rval : 1;
        ++count;
        active = pos < end;
        if (!active || count >= max_tokens) break;
        stand();
        continue;
      }
      const int n = k2 ? 2 : 1;  // tokens of this step
      tokens[slot] = is_len ? (val | (dist << 9) | kMatchBit) : val;
      starts[slot] = outpos;
      if (k2) {
        tokens[slot + lanes] = (e2 >> kEBaseShift) & 511;
        starts[slot + lanes] = outpos + 1;
      }
      slot += n * lanes;
      count += n;
      outpos += is_len ? val : n;
      pos += used;
      if (count >= max_tokens || pos >= end) {
        active = pos < end;
        break;
      }
      // the word registers move on, by selects, when pos enters a new word
      s += used;
      const uint32_t ahead = (uint32_t)w[wq];
      const int wnext = (int)min((unsigned)(wq + 1), last_w);
      if (s >= 32) {
        r1 = r2; r2 = r3; r3 = p0; p0 = ahead;
        wq = wnext;
        s -= 32;
      }
      x0 = nx0;
      x1 = __funnelshift_r(r1, r2, s);
      x2 = __funnelshift_r(r2, r3, s);
      e = e_next;
    }
  }
  const int64_t last = (int64_t)max(count - 1, 0) * lanes + l;
  meta[l] = count;
  meta[(int64_t)lanes + l] = pos;
  meta[2 * (int64_t)lanes + l] = err;
  meta[3 * (int64_t)lanes + l] = active ? 1 : 0;
  meta[4 * (int64_t)lanes + l] = count ? tokens[last] : 0;
  meta[5 * (int64_t)lanes + l] = count ? starts[last] : 0;
}

// ---------------------------------------------------------------- resolve
// Two kernels, launched back to back by zt_resolve_wide.
//
// expand: everything that depends on no earlier tile, for all tiles of all
// rows at once.  A block of 512 threads owns one 4 KiB tile: it has the
// tile's 32 sub-spans of starts and tokens in flight with eight 16-byte
// loads per thread, stages four sub-spans at a time in shared memory,
// binary-searches each byte's covering slot there (the same branch-free
// search as the plain version, so unsorted starts give the same slot) and
// keeps the tile's 4,096 states in shared memory: a literal or a self-copy
// is final (kFlag), a source before the tile is the offset in the row
// (kFar), a source inside the tile is a pointer to that entry.  The
// pointers are then jumped inside the block, without a barrier between
// rounds: a pointer always leads to an earlier entry, which is at any time
// final, far or a pointer to a byte of the same value, so a racing read is
// as good as an ordered one, and a warp leaves the loop when none of its
// entries is a pointer any more.  What goes out, 4 bytes of state per
// output byte, is final or far.  Bound by memory: all of toks and starts
// read once.
//
// walk: only the copying from earlier tiles is serial.  One block per row
// takes the row's tiles in order; each thread has the states of its four
// bytes of the next two tiles in flight in registers, reads a far source
// as one byte of the row, which stays in shared memory, and writes its
// four bytes as one word; one barrier a tile makes them visible to the
// next.  The row leaves shared memory once, 16 bytes a thread.  A row too
// long for shared memory takes the same kernel with the row's bytes in the
// output array (kRowInSmem false), far sources read from L2.

constexpr int kFar = 1 << 29;       // state: source offset in the row
constexpr int kExpandThreads = 512;
constexpr int kSubsPerRound = kExpandThreads / kSub;  // staged together
// a thread's bytes of the tile: one per staging round
constexpr int kExpandPerThread = kTile / kExpandThreads;
constexpr int kWalkThreads = kTile / 4;  // four bytes of a tile per thread
constexpr int kMaxDynamicSmem = 232448;  // 227 KB a block on sm_90

__global__ void __launch_bounds__(kExpandThreads, 2)
resolve_wide_expand_kernel(const int32_t* __restrict__ toks,
                           const int32_t* __restrict__ starts, int nsubb,
                           int32_t* __restrict__ state) {
  // four sub-spans' starts (256 int4), then their tokens (256 int4)
  __shared__ int4 s_stage[kExpandThreads];
  __shared__ int32_t s_tile[kTile];
  const int tid = threadIdx.x;
  const int tiles_per_row = nsubb * kSub / kTile;
  const int t0 = (blockIdx.x % tiles_per_row) * kTile;  // offset in the row
  const int n = nsubb * kSub;
  // the tile's sub-spans lie one after another in toks and starts
  constexpr int kInt4PerRound = kSubsPerRound * kTokensPad / 4;
  const int4* in = reinterpret_cast<const int4*>(
                       tid < kInt4PerRound ? starts : toks) +
                   (int64_t)blockIdx.x * (kTile / kSub) * (kTokensPad / 4) +
                   tid % kInt4PerRound;
  int4 pre[kExpandPerThread];
#pragma unroll
  for (int r = 0; r < kExpandPerThread; ++r)
    pre[r] = __ldg(in + r * kInt4PerRound);

  const int32_t* sp = reinterpret_cast<const int32_t*>(s_stage) +
                      (tid / kSub) * kTokensPad;
  const int32_t* tp = sp + kSubsPerRound * kTokensPad;
  const int qs = tid % kSub;
#pragma unroll
  for (int r = 0; r < kExpandPerThread; ++r) {
    s_stage[tid] = pre[r];
    __syncthreads();
    // largest slot with start <= qs (slot 0 when none): branch-free
    int lo = 0;
#pragma unroll
    for (int step = kTokensPad / 2; step; step >>= 1)
      if (sp[lo + step] <= qs) lo += step;
    const int tok = tp[lo];
    const int ql = r * kExpandThreads + tid;  // byte offset in the tile
    const int q = t0 + ql;
    int v;
    if (tok & kMatchBit) {
      const int dist = (tok >> 9) & 0xFFFF;
      const int src = min(max(q - dist, 0), n - 1);
      if (src == q)
        v = (q & 255) | kFlag;  // a byte copying itself keeps its index
      else if (src >= t0)
        v = src - t0;
      else
        v = src | kFar;
    } else {
      v = (tok & 255) | kFlag;
    }
    s_tile[ql] = v;
    __syncthreads();
  }

  // jump the tile's inner pointers until every entry is final or far
  volatile int32_t* tile = s_tile;
  constexpr int kClosed = kFlag | kFar;
  int v[kExpandPerThread];
  bool pending = false;
#pragma unroll
  for (int k = 0; k < kExpandPerThread; ++k) {
    v[k] = tile[tid + k * kExpandThreads];
    pending |= !(v[k] & kClosed);
  }
  while (__any_sync(0xFFFFFFFFu, pending)) {
    // the loads first, all in flight together (a closed entry reads itself)
    int y[kExpandPerThread];
#pragma unroll
    for (int k = 0; k < kExpandPerThread; ++k)
      y[k] = tile[(v[k] & kClosed) ? tid + k * kExpandThreads : v[k]];
    pending = false;
#pragma unroll
    for (int k = 0; k < kExpandPerThread; ++k) {
      if (v[k] & kClosed) continue;
      v[k] = y[k];
      tile[tid + k * kExpandThreads] = y[k];
      pending |= !(y[k] & kClosed);
    }
  }
  int32_t* out = state + (int64_t)blockIdx.x * kTile;
#pragma unroll
  for (int k = 0; k < kExpandPerThread; ++k)
    out[tid + k * kExpandThreads] = v[k];
}

template <bool kRowInSmem>
__global__ void __launch_bounds__(kWalkThreads)
resolve_wide_walk_kernel(const int32_t* __restrict__ state, int n,
                         uint8_t* out) {
  extern __shared__ int4 smem4[];
  uint8_t* o = out + (int64_t)blockIdx.x * n;
  // the row's resolved bytes: shared memory, or the output array itself
  uint8_t* rowb = kRowInSmem ? reinterpret_cast<uint8_t*>(smem4) : o;
  const int tid = threadIdx.x;
  const int ntiles = n / kTile;
  // this thread's four states of tile i are st[i * kWalkThreads]
  const int4* st =
      reinterpret_cast<const int4*>(state + (int64_t)blockIdx.x * n) + tid;

  // a byte of an earlier tile: final since the barrier that opened this one
  auto byte_of = [&](int x) -> uint32_t {
    if (x & kFlag) return x & 255;
    if constexpr (kRowInSmem)
      return rowb[x & (kFar - 1)];
    else
      return __ldcg(rowb + (x & (kFar - 1)));  // from L2, where stores are
  };

  int4 cur = __ldg(st);
  int4 nxt = ntiles > 1 ? __ldg(st + kWalkThreads) : cur;
  for (int i = 0; i < ntiles; ++i) {
    const int4 ahead =
        i + 2 < ntiles ? __ldg(st + (int64_t)(i + 2) * kWalkThreads) : cur;
    if (i) __syncthreads();  // the bytes of tile i - 1 are visible
    const uint32_t word = byte_of(cur.x) | (byte_of(cur.y) << 8) |
                          (byte_of(cur.z) << 16) | (byte_of(cur.w) << 24);
    *reinterpret_cast<uint32_t*>(rowb + i * kTile + 4 * tid) = word;
    cur = nxt;
    nxt = ahead;
  }
  if (kRowInSmem) {
    __syncthreads();
    for (int i = tid * 16; i < n; i += kWalkThreads * 16)
      *reinterpret_cast<int4*>(o + i) =
          *reinterpret_cast<const int4*>(rowb + i);
  }
}

// ----------------------------------------------------------------- lanes
// wide_lanes: each decode lane's span from the index's anchors, one thread a
// lane.  Lane l = cb * lpb + m takes anchor j = first + m of its coded
// block's row (first, count, out_start, end_bit) when m < count; its end is
// the next anchor, or end_bit for the block's last lane.  Neighbouring
// threads read neighbouring anchors and write neighbouring lanes: 16 B an
// anchor in, 16 B a lane out, so bytes bind it.  The status word is folded a
// block at a time (__syncthreads_or for the flag, warp and block maxima for
// the widest end bit), one atomic each a block.
constexpr int kLanesThreads = 256;
constexpr int64_t kRelLimit = kSub + 258 + 1;  // REL_LIMIT: SUB + MAX_MATCH + 1
constexpr int64_t kInt32Max = 0x7FFFFFFF;

__global__ void __launch_bounds__(kLanesThreads)
wide_lanes_kernel(const int64_t* __restrict__ abit,
                  const int64_t* __restrict__ aout, int64_t na,
                  const int64_t* __restrict__ rows, int lanes, int lpb,
                  int32_t* __restrict__ start_w, int32_t* __restrict__ bit0,
                  int32_t* __restrict__ endb, int32_t* __restrict__ base,
                  int32_t* status) {
  __shared__ int s_max[kLanesThreads / 32];
  const int l = blockIdx.x * kLanesThreads + threadIdx.x;
  bool bad = false;
  int widest = 0;
  if (l < lanes) {
    const int cb = l / lpb;
    const int m = l - cb * lpb;
    const int64_t* row = rows + 4 * (int64_t)cb;
    const int64_t count = row[1];
    const int64_t j = row[0] + m;
    int64_t w = 0, b = 0, e = 0, rel = 0;
    if (m < count && j < na) {
      const bool last = m == count - 1 || j + 1 >= na;
      const int64_t a = abit[j];
      const int64_t next = last ? row[3] : abit[j + 1];
      rel = aout[j] - row[2] - (int64_t)m * kSub;
      w = a >> 5;
      b = a & 31;
      e = next - (w << 5);
      bad = (!last && next < a) || rel < 0 || rel >= kRelLimit;
      widest = (int)(e < 0 ? 0 : e > kInt32Max ? kInt32Max : e);
    }
    start_w[l] = (int32_t)w;
    bit0[l] = (int32_t)b;
    endb[l] = (int32_t)e;
    base[l] = (int32_t)rel;
  }
  widest = __reduce_max_sync(0xFFFFFFFFu, widest);
  if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = widest;
  // the barrier also makes s_max visible
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(status, 1);
  if (threadIdx.x < 32) {
    widest = threadIdx.x < kLanesThreads / 32 ? s_max[threadIdx.x] : 0;
    widest = __reduce_max_sync(0xFFFFFFFFu, widest);
    if (threadIdx.x == 0 && widest > 0) atomicMax(status + 1, widest);
  }
}

}  // namespace

extern "C" {

// sw: window words a lane, at most 255 (the window area and the tables
// together stay under the 48 KB a block has without opting in to more)
int zt_decode_wide(const void* words, int64_t nwords, const void* start_w,
                   int sw, const void* bit0, const void* endb,
                   const void* base, const void* lt, const void* dt,
                   int lanes, int lpb, int max_tokens, void* tokens,
                   void* starts, void* meta, void* stream) {
  unsigned blocks = (unsigned)((lanes + kDecodeLanes - 1) / kDecodeLanes);
  const size_t win_bytes = (size_t)kDecodeLanes * (sw + 1) * sizeof(int32_t);
  if (win_bytes > 32 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)win_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  decode_wide_kernel<<<blocks, kDecodeThreads, win_bytes,
                       (cudaStream_t)stream>>>(
      (const int32_t*)words, nwords, (const int32_t*)start_w, sw,
      (const int32_t*)bit0, (const int32_t*)endb, (const int32_t*)base,
      (const int32_t*)lt, (const int32_t*)dt, lanes, lpb, max_tokens,
      (int32_t*)tokens, (int32_t*)starts, (int32_t*)meta);
  return (int)cudaGetLastError();
}

// state: scratch of rows * nsubb * 128 int32, allocated by the wrapper
int zt_resolve_wide(const void* toks, const void* starts, int rows,
                    int nsubb, void* state, void* out, void* stream) {
  const int n = nsubb * kSub;
  const int64_t tiles = (int64_t)rows * (n / kTile);
  resolve_wide_expand_kernel<<<(unsigned)tiles, kExpandThreads, 0,
                               (cudaStream_t)stream>>>(
      (const int32_t*)toks, (const int32_t*)starts, nsubb, (int32_t*)state);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n <= kMaxDynamicSmem) {
    err = cudaFuncSetAttribute(resolve_wide_walk_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, n);
    if (err != cudaSuccess) return (int)err;
    resolve_wide_walk_kernel<true><<<(unsigned)rows, kWalkThreads, n,
                                     (cudaStream_t)stream>>>(
        (const int32_t*)state, n, (uint8_t*)out);
  } else {
    resolve_wide_walk_kernel<false><<<(unsigned)rows, kWalkThreads, 0,
                                      (cudaStream_t)stream>>>(
        (const int32_t*)state, n, (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}

// abit, aout: (na,) int64; rows: (lanes / lpb, 4) int64; start_w, bit0,
// endb, base: (lanes,) int32; status: (2,) int32, zeroed by the wrapper
int zt_wide_lanes(const void* abit, const void* aout, int64_t na,
                  const void* rows, int lanes, int lpb, void* start_w,
                  void* bit0, void* endb, void* base, void* status,
                  void* stream) {
  const unsigned blocks = (unsigned)((lanes + kLanesThreads - 1) /
                                     kLanesThreads);
  wide_lanes_kernel<<<blocks, kLanesThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)abit, (const int64_t*)aout, na, (const int64_t*)rows,
      lanes, lpb, (int32_t*)start_w, (int32_t*)bit0, (int32_t*)endb,
      (int32_t*)base, (int32_t*)status);
  return (int)cudaGetLastError();
}

}  // extern "C"
