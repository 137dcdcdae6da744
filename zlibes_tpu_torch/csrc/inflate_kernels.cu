// Generic indexed inflate kernels for Hopper (sm_90a): decode_tokens and
// resolve_global.
//
// Two kernels per stage of zlibes_tpu_torch/ops/inflate_kernel.py (the
// resolve takes one more launch a round), launched back to back by a plain
// extern "C" launcher that takes device pointers and a CUDA stream,
// launches on that stream, and returns cudaGetLastError().  The Python
// wrappers check shapes, types and devices and allocate every output and
// scratch array; the plain PyTorch versions beside them define the same
// results.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -c -Xcompiler -fPIC -o inflate_kernels.o inflate_kernels.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_decode.cuh"

namespace {

using namespace lane_decode;

constexpr int kMatchBit = 1 << 25;  // TOK_MATCH_BIT

// ---------------------------------------------------------------- decode
// Two kernels.  flatten: every table row of the call becomes one-level
// roots in a scratch array (FLAT_W entries a row: 11 bits of litlen, 8 of
// distance, 9 KB), one thread an entry, repacked as decode_wide repacks
// them (lane_decode.cuh); a root that a longer code decides is marked so.
// A row is flattened once a call, whichever lanes read it, and read
// through L1: rows are not staged per block (neighbouring lanes share a
// row, eight 4 KiB anchors of a 32 KiB block of output on the flushed
// stream; 32 lanes reading a staged row through generic loads took 1.6x as
// long in tools/probe_decode_tokens.py), and a single lane (the scan) pays
// for one row.
//
// walk: one thread a lane, a warp a block.  The kernel's time is its
// longest lane's chain of tokens on a warp that runs alone (a generic lane
// is ~4 KiB of output, up to ~1,900 stream words, the longest of the bench
// group 1,945 tokens), so a step is cut to what the chain needs.  It is
// decode_wide's walk (wide_kernels.cu) on lanes of any length:
//
//  * a warp pays for every rare step and every branch of any of its lanes:
//    on the bench group 32 lanes a block take ~490 cycles a token of the
//    longest lane, 4 lanes ~260, and 1 or 2 lanes (more warps an SM) a few
//    percent more than 4 (chip_smoke.py, tools/probe_decode_tokens.py), so
//    a block takes as few lanes as make two blocks an SM at most: 4 of the
//    bench group's 940, 1 of the scan's single lane, 32 of a full group of
//    8,192;
//  * the fast step indexes the row's flat roots through L1 with no branch;
//  * the lane keeps the 96 stream bits at its position in three registers
//    and the next two words behind them; positions and word indices are
//    32-bit, from the lane's first word.  A lane is too long to stage
//    (32 lanes of ~1,900 words are more than a block's 227 KB), so words
//    come from global memory: the word a step may move into the view was
//    loaded a step before (loaded in the step, the kernel takes 12% longer;
//    a prefetch of the line 32 or 64 words on gains nothing);
//  * a step takes two literals when the entry behind a literal is a
//    literal too and a second slot is free; the next step's lookup goes out
//    before this step is judged; the output position stays off the lookup
//    chain; a lane's last token stays in the fast step;
//  * every rare case (end of block, an invalid or a long code, an invalid
//    distance code, a token that ends past the lane's end, 32 bits or
//    more) takes one token through the row's two-level tables with the
//    plain version's checks in its order, and sets the registers up again.
//
// Tokens and starts stay (T, B): a warp's stores land on neighbouring
// addresses.  Slots at or past a lane's count are not written.

constexpr int kDecodeLanes = 32;     // most lanes a block: one warp
constexpr int kLlFastBits = 11;      // one-level litlen root of the fast step
constexpr int kLlFast = 1 << kLlFastBits;
constexpr int kDFastBits = 8;        // one-level distance root
constexpr int kDFast = 1 << kDFastBits;
constexpr int kFlatW = kLlFast + kDFast;  // FLAT_W: entries of a flat row
constexpr int kMaxDist = 32768;           // RFC 1951's largest distance
constexpr int kFlattenThreads = 256;

__global__ void __launch_bounds__(kFlattenThreads)
decode_tokens_flatten_kernel(const int32_t* __restrict__ lt,
                    const int32_t* __restrict__ dt, int nrows,
                    int32_t* __restrict__ flat) {
  const int64_t n = (int64_t)nrows * kFlatW;
  for (int64_t j = (int64_t)blockIdx.x * kFlattenThreads + threadIdx.x;
       j < n; j += (int64_t)gridDim.x * kFlattenThreads) {
    const int64_t row = j / kFlatW;
    const int i = (int)(j - row * kFlatW);
    flat[j] = i < kLlFast
                  ? flat_lt_entry(lt + row * kLlW, i, kLlFastBits)
                  : flat_dt_entry(dt + row * kDW, i - kLlFast, kDFastBits,
                                  kMaxDist);
  }
}

__global__ void __launch_bounds__(kDecodeLanes)
decode_tokens_kernel(const uint32_t* __restrict__ words, int64_t nwords,
                     const int32_t* __restrict__ lt,
                     const int32_t* __restrict__ dt,
                     const int32_t* __restrict__ flat, int nrows,
                     const int32_t* __restrict__ table_row,
                     const int64_t* __restrict__ bit0,
                     const int64_t* __restrict__ end_bit,
                     const bool* __restrict__ active0, int lanes,
                     int max_tokens, int32_t* __restrict__ tokens,
                     int32_t* __restrict__ starts,
                     int32_t* __restrict__ count_out,
                     int64_t* __restrict__ bitpos_out,
                     bool* __restrict__ active_out,
                     bool* __restrict__ err_out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const int64_t row = min(max(table_row[l], 0), nrows - 1);
  const int32_t* lt_r = lt + row * kLlW;
  const int32_t* dt_r = dt + row * kDW;
  const int32_t* lf = flat + row * kFlatW;  // the row's flat roots
  auto ll_fast = [&](uint32_t x) -> int {
    return __ldg(lf + (x & (kLlFast - 1)));
  };
  auto d_fast = [&](uint32_t y) -> int {
    return __ldg(lf + kLlFast + (y & (kDFast - 1)));
  };
  const int64_t start = bit0[l];
  // the lane's end bit from its start, clipped to [0, 2^31 - 64): a lane
  // whose end lies at or before its start errs at its first token, as it
  // would unclipped; one of 2^31 bits or more errs at the clip
  const int span =
      (int)max(min(end_bit[l] - start, (int64_t)INT32_MAX - 64), (int64_t)0);
  int pos = 0;
  bool active = active0[l];
  bool err = false;
  int count = 0;
  if (active && max_tokens > 0) {
    // word i of the lane is words[w0 + i]; 0 outside [0, nwords)
    const int64_t w0 = start >> 5;
    const int s0 = (int)(start & 31);
    const uint32_t* wp = words + w0;
    const int lo = (int)min(max(-w0, (int64_t)0), (int64_t)INT32_MAX);
    const int hi =
        (int)min(max(nwords - w0, (int64_t)lo), (int64_t)INT32_MAX);
    auto word = [&](int i) -> uint32_t {
      return (unsigned)(i - lo) < (unsigned)(hi - lo) ? __ldg(wp + i) : 0u;
    };
    uint32_t x0, x1, x2;      // the 96 stream bits at pos, LSB-first
    uint32_t r1, r2, r3, p0;  // words: x1 = r1:r2 >> s, x2 = r2:r3 >> s
    uint32_t ahead;           // word wq, loaded a step before p0 takes it
    int wq;                   // index of the word after p0
    int s;                    // (s0 + pos) & 31
    int e;                    // the flat entry of the token at pos
    // the registers of a walk that stands at pos
    auto stand = [&]() {
      const int q = s0 + pos;
      const int wi = q >> 5;
      s = q & 31;
      const uint32_t r0 = word(wi);
      r1 = word(wi + 1);
      r2 = word(wi + 2);
      r3 = word(wi + 3);
      p0 = word(wi + 4);
      wq = wi + 5;
      ahead = word(wq);
      x0 = __funnelshift_r(r0, r1, s);
      x1 = __funnelshift_r(r1, r2, s);
      x2 = __funnelshift_r(r2, r3, s);
      e = ll_fast(x0);
    };
    stand();
    int slot = l;  // of the next token, in tokens and in starts
    int outpos = 0;
    for (;;) {
      const int k1 = e & kEUsedMask;
      // the bits behind the first token
      const uint32_t y0 = __funnelshift_r(x0, x1, e);
      const uint32_t y1 = __funnelshift_r(x1, x2, e);
      // both lookups there go out for every token, with no branch: the
      // distance entry counts behind a length (a clamped shift by 32 leaves
      // 0), the litlen entry behind a literal when it is a literal too and a
      // second slot is free
      const int de = d_fast(y0);
      const int e2 = ll_fast(y0);
      const bool is_len = (e & kELen) != 0;
      const int dshift = is_len ? kDUsedShift : 32;
      const int lit_mask =
          ((uint32_t)e >> kELitShift) != 0 && count + 2 <= max_tokens
              ? kEUsedMask : 0;
      const int k2 = (int)((uint32_t)e2 >> kELitShift) & lit_mask;
      const int more = (int)__funnelshift_rc((uint32_t)de, 0u, dshift) | k2;
      const uint32_t nx0 = __funnelshift_r(y0, y1, more);
      // the next step's lookup goes out before this step is judged
      const int e_next = ll_fast(nx0);
      const int used = k1 + more;
      const int val = ((e >> kEBaseShift) & 511) +
                      (is_len ? (int)bits_at(x0, (e >> kELnShift) & 15,
                                             (e >> kEEbShift) & 7)
                              : 0);
      const int dist = ((de >> 8) & 0x7FFF) +
                       (int)bits_at(y0, de & 15, (de >> 4) & 15);
      if ((e & (kEEob | kEBad)) ||
          (uint32_t)(used - 1) >= (uint32_t)min(span - pos, 31)) {
        // rare: one token through the two-level tables, every check
        const int er = lookup_ll<true>(lt_r, x0);
        const int ln = er & 15, kind = (er >> 4) & 3, eb = (er >> 6) & 7;
        const bool rlen = kind == kKindLen;
        const int rval =
            ((er >> 9) & 511) + (rlen ? (int)bits_at(x0, ln, eb) : 0);
        const uint32_t yr = __funnelshift_r(x0, x1, ln + eb);
        const int dr = lookup_d<true>(dt_r, yr);
        const int dln = dr & 15, deb = (dr >> 4) & 15;
        const int newpos = pos + ln + eb + (rlen ? dln + deb : 0);
        if (ln == 0 || kind == kKindInvalid || (rlen && dln == 0) ||
            newpos > span) {
          err = true;
          active = false;
          break;
        }
        pos = newpos;
        if (kind == kKindEob) {
          active = false;
          break;
        }
        tokens[slot] =
            rlen ? (rval | (token_dist(dr, yr) << 9) | kMatchBit) : rval;
        starts[slot] = outpos;
        slot += lanes;
        outpos += rlen ? rval : 1;
        ++count;
        active = pos < span;
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
      if (count >= max_tokens || pos >= span) {
        active = pos < span;
        break;
      }
      // the word registers move on, by selects, when pos enters a new word;
      // the word that p0 takes next goes out now
      s += used;
      if (s >= 32) {
        r1 = r2; r2 = r3; r3 = p0; p0 = ahead;
        ++wq;
        s -= 32;
      }
      ahead = word(wq);
      x0 = nx0;
      x1 = __funnelshift_r(r1, r2, s);
      x2 = __funnelshift_r(r2, r3, s);
      e = e_next;
    }
  }
  count_out[l] = count;
  bitpos_out[l] = start + pos;
  active_out[l] = active;
  err_out[l] = err;
}

// ---------------------------------------------------------------- resolve
// One expand kernel, then one launch a round, back to back from
// zt_resolve_global.  A byte's state is one int32: final (kFinal | byte),
// or the position of the byte it copies, which always lies before it.
//
// expand: a block of 512 threads owns a 4 KiB tile of output bytes, so
// both shapes the callers give, (8,192, 940) lanes of a group and one lane
// of ~1M tokens of the scan, spread over all SMs, and no thread looks at a
// slot past its lane's count.  Lanes tile the span in order: a warp finds
// the lanes that reach into the tile by a search over out_base, and a warp
// a lane the tokens that do by a search over the lane's ascending starts
// (32 probes at once, log32 of the lane's count dependent loads); the
// block copies those tokens into shared memory and each byte finds its
// token there by a branch-free binary search.  A byte below P is the
// prefix's, a literal is final, a copy byte's source follows the
// reference's modular rule (start - dist + (q - start) % dist; a source
// below 0 sets err and reads byte 0; one in the prefix is read from it at
// once), a byte no token covers and the bytes of a dist-0 match are final
// 0.  Sources inside the tile are pointers into the tile's states in
// shared memory, which are jumped without a barrier between rounds, as
// resolve_wide's expand jumps them (a pointer leads to an earlier entry,
// which at any time is final, before the tile or a pointer to a byte of
// the same value, so a racing read is as good as an ordered one).  What
// goes out is final (its byte written to out as well) or a source before
// the tile, and one flag a tile says whether any is.
//
// round: a block a tile again, and a tile with nothing open returns at
// once, as does every block once a round before left nothing open (one
// flag a round, so no launch ever waits on another).  Each open byte
// follows up to kHops pointers, all of a thread's bytes at once, writes
// the final byte or the pointer it reached, in place (a racing read sees
// the old or a newer state on the same chain).  A source always lies in an
// earlier tile, so a chain has fewer hops than there are tiles, and a
// round multiplies every pointer's reach by kHops + 1: the wrapper's
// ceil(log_(kHops+1)(tiles)) rounds finish any chain the span can hold.

constexpr int kFinal = (int)0x80000000u;  // state: final byte in bits 0-7
constexpr int kTile = 4096;               // RESOLVE_TILE: bytes a block
constexpr int kResolveThreads = 512;
constexpr int kBytesPerThread = kTile / kResolveThreads;
constexpr int kHops = 16;                 // RESOLVE_HOPS: pointers a round
constexpr int kLaneChunk = 32;            // lanes searched at once

// The first i in [lo, hi) with v(i) > key (hi when there is none), for v
// ascending on [lo, hi), found by the 32 threads of a warp together (all
// call it with the same arguments): each round probes 32 evenly spaced
// indices at once.
template <class F>
__device__ __forceinline__ int warp_upper_bound(int lo, int hi, int key,
                                                F v) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const int step = (int)(((unsigned)(hi - lo) + 31u) >> 5);
    const int i = lo + lane * step;
    const int c = __popc(__ballot_sync(0xFFFFFFFFu, i < hi && v(i) <= key));
    if (c == 0) return lo;
    const int next_lo = lo + (c - 1) * step + 1;
    hi = min(lo + c * step, hi);
    lo = next_lo;
  }
  return lo;
}

__global__ void __launch_bounds__(kResolveThreads)
resolve_global_expand_kernel(const int32_t* __restrict__ tokens,
                             const int32_t* __restrict__ starts,
                             const int32_t* __restrict__ count,
                             const int32_t* __restrict__ out_base, int T,
                             int lanes, const uint8_t* __restrict__ prefix,
                             int P, int total, int32_t* __restrict__ state,
                             uint8_t* __restrict__ out,
                             int32_t* __restrict__ tile_open,
                             int32_t* __restrict__ open0,
                             int32_t* __restrict__ err) {
  // the tile's tokens in order: first byte from t0 (INT32_MAX past the
  // last), packed token; s_pos then holds the tile's states
  __shared__ int s_pos[kTile];
  __shared__ int s_tok[kTile];
  __shared__ int s_first[kLaneChunk], s_n[kLaneChunk], s_off[kLaneChunk + 1];
  __shared__ int s_lanes[2];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int kWarps = kResolveThreads / 32;
  const int t0 = blockIdx.x * kTile;
  const int t1 = min(t0 + kTile, total);

  // the lanes that can reach into [t0, t1): from the last whose first byte
  // is at or before t0 to the last whose first byte is before t1
  if (warp == 0) {
    auto base = [&](int b) { return __ldg(out_base + b); };
    const int b0 = max(warp_upper_bound(0, lanes, t0, base) - 1, 0);
    const int b1 = warp_upper_bound(b0, lanes, t1 - 1, base);
    if (lane == 0) {
      s_lanes[0] = b0;
      s_lanes[1] = b1;
    }
  }
  for (int i = tid; i < kTile; i += kResolveThreads) s_pos[i] = INT32_MAX;
  __syncthreads();
  const int b_end = s_lanes[1];
  int staged = 0;
  for (int c = s_lanes[0]; c < b_end; c += kLaneChunk) {
    // a warp a lane: its tokens from the last starting at or before t0 to
    // the last starting before t1
    for (int j = warp; j < kLaneChunk; j += kWarps) {
      const int b = c + j;
      int first = 0, n = 0;
      if (b < b_end) {
        const int base = __ldg(out_base + b);
        const int cnt = min(max(__ldg(count + b), 0), T);
        auto st = [&](int t) {
          return __ldg(starts + (int64_t)t * lanes + b);
        };
        first = max(warp_upper_bound(0, cnt, t0 - base, st) - 1, 0);
        n = warp_upper_bound(first, cnt, t1 - 1 - base, st) - first;
      }
      if (lane == 0) {
        s_first[j] = first;
        s_n[j] = n;
      }
    }
    __syncthreads();
    if (warp == 0) {
      int incl = s_n[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        if (lane >= d) incl += up;
      }
      s_off[lane + 1] = incl;
      if (lane == 0) s_off[0] = 0;
    }
    __syncthreads();
    const int chunk = s_off[kLaneChunk];
    for (int k = tid; k < chunk; k += kResolveThreads) {
      int j = 0;  // the lane of staged token k: the last j with s_off[j] <= k
#pragma unroll
      for (int step = kLaneChunk / 2; step; step >>= 1)
        if (s_off[j + step] <= k) j += step;
      const int dst = staged + k;
      if (dst < kTile) {  // more only where lanes overlap (a corrupt decode)
        const int b = c + j;
        const int64_t idx = (int64_t)(s_first[j] + k - s_off[j]) * lanes + b;
        s_tok[dst] = __ldg(tokens + idx);
        s_pos[dst] = __ldg(out_base + b) + __ldg(starts + idx) - t0;
      }
    }
    staged += chunk;
    __syncthreads();
  }

  // each byte's state: thread tid has bytes tid + i * 512
  int v[kBytesPerThread];
  bool below = false;
#pragma unroll
  for (int i = 0; i < kBytesPerThread; ++i) {
    const int ql = tid + i * kResolveThreads;
    const int q = t0 + ql;
    int x = kFinal;
    if (q < t1 && q < P) {
      x = kFinal | prefix[q];
    } else if (q < t1) {
      // the last staged token starting at or before ql (branch-free)
      int k = 0;
#pragma unroll
      for (int step = kTile / 2; step; step >>= 1)
        if (s_pos[k + step] <= ql) k += step;
      const int g = s_pos[k], tok = s_tok[k];
      const bool match = (tok & kMatchBit) != 0;
      const int dist = (tok >> 9) & 0xFFFF;
      if (g <= ql && ql - g < (match ? (tok & 511) : 1)) {
        if (!match) {
          x = kFinal | (tok & 255);
        } else if (dist) {
          const int off = ql - g;
          int src = q - off - dist + (off < dist ? off : off % dist);
          if (src < 0) {
            below = true;
            src = 0;
          }
          // src == q only for byte 0 copying from below 0: it stays 0
          x = src < P ? (kFinal | prefix[src]) : src == q ? kFinal : src;
        }
      }
    }
    v[i] = x;
  }
  if (below) *err = 1;
  __syncthreads();  // every byte has found its token: s_pos takes the states

  // jump the pointers inside the tile until each state is final or before it
  volatile int* tile = s_pos;
  bool pending = false;
#pragma unroll
  for (int i = 0; i < kBytesPerThread; ++i) {
    tile[tid + i * kResolveThreads] = v[i];
    pending |= v[i] >= t0;
  }
  __syncthreads();
  while (__any_sync(0xFFFFFFFFu, pending)) {
    // the loads first, all in flight together
    int y[kBytesPerThread];
#pragma unroll
    for (int i = 0; i < kBytesPerThread; ++i)
      y[i] = v[i] >= t0 ? tile[v[i] - t0] : v[i];
    pending = false;
#pragma unroll
    for (int i = 0; i < kBytesPerThread; ++i) {
      if (v[i] < t0) continue;
      v[i] = y[i];
      tile[tid + i * kResolveThreads] = y[i];
      pending |= y[i] >= t0;
    }
  }
  bool open = false;
#pragma unroll
  for (int i = 0; i < kBytesPerThread; ++i) {
    const int q = t0 + tid + i * kResolveThreads;
    if (q >= t1) continue;
    state[q] = v[i];
    if (v[i] < 0)
      out[q] = (uint8_t)v[i];
    else
      open = true;
  }
  open = __syncthreads_or(open);
  if (tid == 0) {
    tile_open[blockIdx.x] = open;
    if (open) *open0 = 1;
  }
}

__global__ void __launch_bounds__(kResolveThreads)
resolve_global_round_kernel(int32_t* state, int total,
                            int32_t* __restrict__ tile_open,
                            int32_t* __restrict__ open, int round,
                            uint8_t* __restrict__ out) {
  // open[round]: the round before (the expand for round 0) left a byte open
  if (!open[round] || !tile_open[blockIdx.x]) return;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kTile;
  const int t1 = min(t0 + kTile, total);
  int p[kBytesPerThread];
  bool mine = false;
#pragma unroll
  for (int i = 0; i < kBytesPerThread; ++i) {
    const int q = t0 + tid + i * kResolveThreads;
    p[i] = q < t1 ? state[q] : kFinal;
    mine |= p[i] >= 0;
  }
  volatile int32_t* st = state;
  for (int h = 0; h < kHops && mine; ++h) {
    int y[kBytesPerThread];
#pragma unroll
    for (int i = 0; i < kBytesPerThread; ++i)
      y[i] = p[i] >= 0 ? st[p[i]] : p[i];
    mine = false;
#pragma unroll
    for (int i = 0; i < kBytesPerThread; ++i) {
      if (p[i] < 0) continue;
      p[i] = y[i];
      if (y[i] < 0) {
        const int q = t0 + tid + i * kResolveThreads;
        st[q] = y[i];
        out[q] = (uint8_t)y[i];
      } else {
        mine = true;
      }
    }
  }
  // the pointers that are still open, each as far as it reached
#pragma unroll
  for (int i = 0; i < kBytesPerThread; ++i)
    if (p[i] >= 0) st[t0 + tid + i * kResolveThreads] = p[i];
  const bool still = __syncthreads_or(mine);
  if (tid == 0) {
    tile_open[blockIdx.x] = still;
    if (still) open[round + 1] = 1;
  }
}

// The SMs of the current device.
int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Lanes a decode block: the fewest (a power of two, at most a warp) for
// which the blocks, one warp each, are at most two an SM.
int decode_lanes_a_block(int lanes) {
  const int64_t blocks = 2 * (int64_t)sm_count();
  int lpb = 1;
  while (lpb < kDecodeLanes && lpb * blocks < lanes) lpb <<= 1;
  return lpb;
}

}  // namespace

extern "C" {

// nrows: rows of lt and dt (a lane's row is clamped into them); flat:
// scratch of nrows * FLAT_W int32
int zt_decode_tokens(const void* words, int64_t nwords, const void* lt,
                     const void* dt, int nrows, void* flat,
                     const void* table_row, const void* bit0,
                     const void* end_bit, const void* active0, int lanes,
                     int max_tokens, void* tokens, void* starts, void* count,
                     void* bitpos, void* active, void* err, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t entries = (int64_t)nrows * kFlatW;
  const int64_t want = (entries + kFlattenThreads - 1) / kFlattenThreads;
  decode_tokens_flatten_kernel<<<(unsigned)(want < 4096 ? want : 4096),
                        kFlattenThreads, 0, s>>>(
      (const int32_t*)lt, (const int32_t*)dt, nrows, (int32_t*)flat);
  const int lpb = decode_lanes_a_block(lanes);
  decode_tokens_kernel<<<(unsigned)((lanes + lpb - 1) / lpb), lpb, 0, s>>>(
      (const uint32_t*)words, nwords, (const int32_t*)lt, (const int32_t*)dt,
      (const int32_t*)flat, nrows, (const int32_t*)table_row,
      (const int64_t*)bit0, (const int64_t*)end_bit, (const bool*)active0,
      lanes, max_tokens, (int32_t*)tokens, (int32_t*)starts, (int32_t*)count,
      (int64_t*)bitpos, (bool*)active, (bool*)err);
  return (int)cudaGetLastError();
}

// state: scratch of total int32; tile_open: scratch of one int32 a 4 KiB
// tile; open: rounds + 1 int32 and err: one int32, both zeroed by the
// wrapper
int zt_resolve_global(const void* tokens, const void* starts,
                      const void* count, const void* out_base, int T,
                      int lanes, const void* prefix, int P, int total,
                      int rounds, void* state, void* tile_open, void* open,
                      void* out, void* err, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned tiles = (unsigned)((total + (int64_t)kTile - 1) / kTile);
  resolve_global_expand_kernel<<<tiles, kResolveThreads, 0, s>>>(
      (const int32_t*)tokens, (const int32_t*)starts, (const int32_t*)count,
      (const int32_t*)out_base, T, lanes, (const uint8_t*)prefix, P, total,
      (int32_t*)state, (uint8_t*)out, (int32_t*)tile_open, (int32_t*)open,
      (int32_t*)err);
  for (int r = 0; r < rounds; ++r)
    resolve_global_round_kernel<<<tiles, kResolveThreads, 0, s>>>(
        (int32_t*)state, total, (int32_t*)tile_open, (int32_t*)open, r,
        (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
