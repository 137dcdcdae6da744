// Encode kernels for Hopper (sm_90a).
//
// select_turbo (zlibes_tpu_torch/ops/turbo_kernel.py), select_tokens
// (zlibes_tpu_torch/ops/lz77.py), encode_fields
// (zlibes_tpu_torch/ops/encode_kernel.py) and block_tables
// (zlibes_tpu_torch/ops/block_tables.py), each with a plain extern "C"
// launcher that takes device pointers and a CUDA stream, launches on that
// stream, and returns cudaGetLastError().  The Python wrappers check shapes,
// types and devices and allocate every output; the plain PyTorch versions
// beside them define the same results.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -c -Xcompiler -fPIC -o encode_kernels.o encode_kernels.cu
// (runtime/kernels.py links it with the other sources into one library)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSeg = 512;           // SEL_SEG: positions per segment lane
constexpr int kLenShift = 12;       // SEL_LEN_SHIFT
constexpr int kLitShift = 21;       // SEL_LIT_SHIFT
constexpr int kDistShift = 9;       // TOK_DIST_SHIFT
constexpr int kMatchBit = 1 << 21;  // TOK_MATCH_BIT
constexpr int kMinMatch = 3;
constexpr int kMaxMatch = 258;
constexpr int kLitlenSyms = 288;
constexpr int kDistSyms = 32;

// ---------------------------------------------------------------- select
// Greedy matching with a one-step lazy defer, in the reference's rule
// order: one rule, select_step, for both select kernels.

// The token at position c and the position that follows it.  ml, dist: the
// best match at c; lit: the byte at c; ml1(): the length of the best match
// at c + 1, asked for only where the defer is open (so only where
// c + 1 < seg_end).  kSplitFar caps far matches (dist > 2048) at 130 bytes,
// as the reference's split_far does for codes of at most 9 bits.  A match
// is ml | dist << 9 | kMatchBitT, a literal its byte.
template <bool kSplitFar, int kMatchBitT, typename NextLen>
__device__ __forceinline__ void select_step(int ml, int dist, int lit,
                                            NextLen ml1, int c, int seg_end,
                                            int lazy, int& tok, int& next) {
  ml = min(ml, seg_end - c);
  if (kSplitFar && ml >= 131 && dist >= 2049) ml = 130;
  bool use = ml >= kMinMatch;
  if (lazy && use && ml < kMaxMatch && c + 1 < seg_end) {
    if (ml1() > ml) use = false;
  }
  tok = use ? (ml | (dist << kDistShift) | kMatchBitT) : lit;
  next = c + (use ? ml : 1);
}

// select_turbo: 512-position lanes, distances of 12 bits; split_far on for
// the turbo profile (codes of at most 9 bits), off for a shared-tables
// config with longer codes (the template flag kSplitFar).
//
// A block of 128 threads owns 8 segment lanes and keeps their rows in 16 KB
// of shared memory.  (1) It copies the rows in with one 16-byte load per
// thread and row, neighbouring threads on neighbouring addresses.  (2) The
// token at a position and the position that follows it depend on that
// position and the next one alone, so all 512 of a row are computed at
// once, four a thread, and packed as token | next << 22.  (3) One thread a
// lane then walks the chain from position 0: one shared-memory load and a
// shift a step, writing token t in place at slot t <= cursor (every later
// read is above the cursor, so the slot is dead).  (4) The block stores
// whole rows, zeros past the count, 16 bytes a thread.  Bound by the
// latency of the longest lane's chain; global memory sees only full-width
// loads and stores.

constexpr int kSelLanes = 8;                // lanes a block
constexpr int kSelThreads = kSeg / 4;       // one int4 of a row per thread
constexpr int kNextShift = 22;              // token: bits 0-21
constexpr int kTokMask = (1 << kNextShift) - 1;

// token | next << 22 of position c, given its packed value and the next
// position's
template <bool kSplitFar>
__device__ __forceinline__ int turbo_step(int cur, int nxt, int c,
                                          int seg_end, int lazy) {
  int tok, next;
  select_step<kSplitFar, kMatchBit>(
      (cur >> kLenShift) & 511, cur & 0xFFF, (cur >> kLitShift) & 0xFF,
      [nxt] { return (nxt >> kLenShift) & 511; }, c, seg_end, lazy, tok, next);
  return tok | (int)((unsigned)next << kNextShift);
}

template <bool kSplitFar>
__global__ void __launch_bounds__(kSelThreads)
select_turbo_kernel(const int32_t* __restrict__ pv,
                    const int32_t* __restrict__ seg_len, int lanes, int lazy,
                    int32_t* __restrict__ toks,
                    int32_t* __restrict__ counts) {
  __shared__ int4 rows[kSelLanes][kSelThreads];
  __shared__ int s_end[kSelLanes];
  __shared__ int s_count[kSelLanes];
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * kSelLanes;
  const int nl = min(kSelLanes, lanes - lane0);
  const int4* in = reinterpret_cast<const int4*>(pv) +
                   (int64_t)lane0 * kSelThreads;
#pragma unroll
  for (int r = 0; r < kSelLanes; ++r)
    if (r < nl) rows[r][tid] = __ldg(in + r * kSelThreads + tid);
  if (tid < nl) s_end[tid] = min(seg_len[lane0 + tid], kSeg);
  __syncthreads();

  int4 packed[kSelLanes];
#pragma unroll
  for (int r = 0; r < kSelLanes; ++r) {
    if (r >= nl) continue;
    const int seg_end = s_end[r];
    const int4 cur = rows[r][tid];
    const int c = 4 * tid;
    // the position after this thread's four; the last position is its own
    // successor, as in the plain version's clamp
    const int after = reinterpret_cast<const int32_t*>(rows[r])[min(c + 4,
                                                                    kSeg - 1)];
    packed[r].x = turbo_step<kSplitFar>(cur.x, cur.y, c, seg_end, lazy);
    packed[r].y = turbo_step<kSplitFar>(cur.y, cur.z, c + 1, seg_end, lazy);
    packed[r].z = turbo_step<kSplitFar>(cur.z, cur.w, c + 2, seg_end, lazy);
    packed[r].w = turbo_step<kSplitFar>(cur.w, after, c + 3, seg_end, lazy);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kSelLanes; ++r)
    if (r < nl) rows[r][tid] = packed[r];
  __syncthreads();

  if (tid < nl) {
    int32_t* row = reinterpret_cast<int32_t*>(rows[tid]);
    const int seg_end = s_end[tid];
    int c = 0;
    int t = 0;
    while (c < seg_end) {
      const int w = row[c];
      row[t++] = w & kTokMask;
      c = (int)((unsigned)w >> kNextShift);
    }
    s_count[tid] = t;
    counts[lane0 + tid] = t;
  }
  __syncthreads();

  int4* outp = reinterpret_cast<int4*>(toks) + (int64_t)lane0 * kSelThreads;
#pragma unroll
  for (int r = 0; r < kSelLanes; ++r) {
    if (r >= nl) continue;
    const int cnt = s_count[r];
    int4 v = rows[r][tid];
    const int c = 4 * tid;
    v.x = c < cnt ? v.x : 0;
    v.y = c + 1 < cnt ? v.y : 0;
    v.z = c + 2 < cnt ? v.z : 0;
    v.w = c + 3 < cnt ? v.w : 0;
    outp[r * kSelThreads + tid] = v;
  }
}

// select_tokens: the general encoder's selection (levels 1-9), and the
// shared-table encoder's outside the turbo profile's 512/4096 geometry.
// Lanes of a run-time length ``seg`` (4,096 by default), distances to
// 32,768, split_far as the template flag kSplitFar (on for a shared-tables
// config with codes of at most 9 bits, off elsewhere: the general
// encoder's instance is unchanged), and a row offset ``start`` (the width
// of a preset dictionary's context prefix, whose positions are match
// sources and never tokens).
// Reads the matcher's (len << 16) | dist and the block's bytes as they are.
// Replaces the reference's XLA while_loop (zlibes_tpu/ops/lz77.py:295).
//
// One block of 256 threads a lane.  The tokens of a lane are the chain from
// position 0 through next[c] > c to seg_len; walking it on one thread costs
// a dependent shared-memory load a token, up to ``seg`` of them.  Here:
//
// (1) Token pass: all threads compute every position's token (one word: val
//     9 | dist 16 << 9 | match bit 25) and its successor (uint16),
//     neighbouring threads on neighbouring positions.
// (2) Speculative walks: the lane is cut into 32 pieces of P positions (a
//     power of two, at least 32), and lane p of warp 0 walks piece p from
//     its first position until it leaves the piece, keeping the positions
//     it visits as bits in a register, a mark word (sbits) at a time.  The
//     32 lanes step through their pieces side by side, so piece p of the
//     successors (and of the walk ids below) lies p banks on, or every
//     step of an all-literal lane would be a 32-way bank conflict.
// (3) Fix-up rounds: piece p assumes it is entered where piece p - 1 was
//     left (at first its speculative exit) and looks its exit up from
//     there: a position a walk of the piece visited has that walk's exit;
//     from any other it walks anew (a walk id in wid[], bits in fbits[])
//     until it leaves the piece or meets a visited position, whose walk's
//     exit it takes.  Exits pass to piece p + 1 by a shuffle; the rounds
//     stop when no entry changes.  LZ parses meet again within a few
//     tokens, so one round of a few steps is the rule; whatever the data,
//     piece p is final after round p + 1 (at most 33 rounds) and a piece's
//     walks visit each of its positions once (at most P steps of walking).
// (4) Marks: along the true chain a piece's walks are entered at its entry
//     and then at each meeting point, each walk in turn an earlier one;
//     lane p records where the chain enters each of them, and position c is
//     a token iff it is at or past that position of its walk: a thread a
//     mark word.
// (5) Rank and store: a block-wide exclusive scan of the words' popcounts
//     gives each token its slot; each warp takes a word (32 positions) at a
//     time, so its tokens go to consecutive slots of the output rows.
//     Zeros past the count.
//
// tools/probe_select_tokens.py holds the other designs it was timed
// against: the first design's single walk, pointer doubling over the
// successors (ceil(log2 count) rounds of a gather a position, twice this
// kernel's time on the bench dispatch), and speculative walks without the
// memory of (3).  Shared memory: 7 bytes a position, two bit words a 32
// positions, 8.6 KB of tables: 38.6 KB at 4,096, so a dispatch's 512 lanes
// are all resident at once; 127.6 KB at 16,384 (dynamic shared memory).
// Bound by the token pass's loads, the store, and the longest piece walk.

constexpr int kTokThreads = 256;
constexpr int kTokWarps = kTokThreads / 32;
constexpr int kWideMatchBit = 1 << 25;
constexpr int kMaxTokSeg = 16384;                // MAX_KERNEL_SEG
constexpr int kMaxMarkWords = kMaxTokSeg / 32;
constexpr int kPieces = 32;                      // a piece a lane of warp 0
// walk ids of a piece: 1 the speculative walk, then one a fix-up round at
// most (rounds 1..kPieces + 1 of which piece p walks in at most p + 1)
constexpr int kWalkIds = kPieces + 2;

// bytes of dynamic shared memory a lane of ``seg`` positions takes: tokens,
// nxt[] and wid[] with a bank of skew a piece, two bit words a 32 positions
__host__ __device__ constexpr int select_tokens_smem(int seg) {
  return ((7 * seg + 8 * kPieces + 3) & ~3) + 8 * ((seg + 31) / 32);
}

__device__ __forceinline__ int warp_inclusive_sum(int v) {
  const int ln = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (ln >= o) v += u;
  }
  return v;
}

// (1): every position's token into tok[c] and its successor into
// nxt[c + 2 * (c >> lg_piece)] (no barrier)
template <bool kSplitFar>
__device__ __forceinline__ void select_tokens_pass(
    const uint8_t* __restrict__ d, const int32_t* __restrict__ m, int seg_len,
    int lazy, int lg_piece, int32_t* tok, uint16_t* nxt) {
  for (int c = threadIdx.x; c < seg_len; c += kTokThreads) {
    const int cur = m[c];
    int t, nx;
    select_step<kSplitFar, kWideMatchBit>(
        cur >> 16, cur & 0xFFFF, d[c], [m, c] { return m[c + 1] >> 16; }, c,
        seg_len, lazy, t, nx);
    tok[c] = t;
    nxt[c + ((c >> lg_piece) << 1)] = (uint16_t)nx;
  }
}

// (5): each marked position's token to the slot its rank gives, in both
// output rows, zeros past the count; the count to *count_out.  ``mark``:
// (seg_len + 31) / 32 words, read only.  Every thread of the block calls it.
__device__ __forceinline__ void store_marked(
    const uint32_t* mark, const int32_t* tok, int seg, int seg_len,
    int32_t* __restrict__ tv_row, int32_t* __restrict__ td_row,
    int32_t* __restrict__ count_out) {
  __shared__ int s_wpre[kMaxMarkWords];  // marks in the words before each
  __shared__ int s_warp[kTokWarps];
  const int tid = threadIdx.x;
  const int nwords = (seg_len + 31) >> 5;
  const int per = (nwords + kTokThreads - 1) / kTokThreads;
  const int w0 = tid * per;
  int s = 0;
  for (int k = 0; k < per; ++k)
    if (w0 + k < nwords) s += __popc(mark[w0 + k]);
  const int incl = warp_inclusive_sum(s);
  if ((tid & 31) == 31) s_warp[tid >> 5] = incl;
  __syncthreads();
  if (tid < 32) {
    const int v = warp_inclusive_sum(tid < kTokWarps ? s_warp[tid] : 0);
    if (tid < kTokWarps) s_warp[tid] = v;
  }
  __syncthreads();
  int pre = incl - s + (tid >= 32 ? s_warp[(tid >> 5) - 1] : 0);
  for (int k = 0; k < per; ++k)
    if (w0 + k < nwords) {
      s_wpre[w0 + k] = pre;
      pre += __popc(mark[w0 + k]);
    }
  __syncthreads();
  const int cnt = s_warp[kTokWarps - 1];
  if (tid == 0) *count_out = cnt;
  for (int c = tid; c < seg; c += kTokThreads) {
    if (c < seg_len) {
      const uint32_t m = mark[c >> 5];
      if ((m >> (c & 31)) & 1u) {
        const int slot = s_wpre[c >> 5] + __popc(m & ((1u << (c & 31)) - 1u));
        // a literal has no bit above its byte, so both fields read as they
        // lie
        const int w = tok[c];
        tv_row[slot] = w & 0x1FF;
        td_row[slot] = (w >> kDistShift) & 0xFFFF;
      }
    }
    if (c >= cnt) {
      tv_row[c] = 0;
      td_row[c] = 0;
    }
  }
}

template <bool kSplitFar>
__global__ void __launch_bounds__(kTokThreads)
select_tokens_kernel(const uint8_t* __restrict__ data, int64_t pitch,
                     const int32_t* __restrict__ matches,
                     const int32_t* __restrict__ n_valid, int N, int nseg,
                     int seg, int start, int lazy, int32_t* __restrict__ tv,
                     int32_t* __restrict__ td, int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char tok_smem[];
  int32_t* tok = reinterpret_cast<int32_t*>(tok_smem);
  // successors and fix-up walk ids of piece p at c + 2p and c + 4p
  uint16_t* nxt = reinterpret_cast<uint16_t*>(tok_smem + 4 * seg);
  uint8_t* wid = tok_smem + 6 * seg + 4 * kPieces;
  // positions the speculative walks visited (then the marks), and those the
  // fix-up walks visited: each word lies in one piece
  uint32_t* sbits = reinterpret_cast<uint32_t*>(
      tok_smem + ((7 * seg + 8 * kPieces + 3) & ~3));
  uint32_t* fbits = sbits + (seg + 31) / 32;
  // per piece and walk id (1: the speculative walk): where the walk left
  // the piece, where it stopped (its exit, or the position of an earlier
  // walk it met), and where the true chain enters it (0xFFFF: nowhere)
  __shared__ uint16_t s_exit[kPieces][kWalkIds];
  __shared__ uint16_t s_stop[kPieces][kWalkIds];
  __shared__ uint16_t s_from[kPieces][kWalkIds];
  const int tid = threadIdx.x;
  const int ln = tid & 31;
  const int lane = blockIdx.x;
  const int b = lane / nseg;
  const int seg0 = start + (lane % nseg) * seg;
  const int seg_len = min(max(n_valid[b] - seg0, 0), seg);
  const int nwords = (seg_len + 31) >> 5;
  int lg_piece = 5;
  while ((kPieces << lg_piece) < seg_len) ++lg_piece;
  const int P = 1 << lg_piece;

  select_tokens_pass<kSplitFar>(data + (int64_t)b * pitch + seg0,
                                matches + (int64_t)b * N + seg0, seg_len,
                                lazy, lg_piece, tok, nxt);
  for (int w = tid; w < nwords; w += kTokThreads) {
    sbits[w] = 0;
    fbits[w] = 0;
  }
  __syncthreads();

  if (tid < 32) {
    const int p = ln;
    const int beg = p * P;
    const int end = beg < seg_len ? min(beg + P, seg_len) : 0;
    const uint16_t* nx = nxt + 2 * p;  // piece p's skewed rows
    uint8_t* wd = wid + 4 * p;
    uint16_t* ex = s_exit[p];
    uint16_t* st = s_stop[p];
    int nwalk = 0;
    if (end) {  // (2), its visits kept in a register word at a time
      int e = beg;
      int word = e >> 5;
      uint32_t bits = 0;
      while (e < end) {
        const int n = nx[e];
        if ((e >> 5) != word) {
          sbits[word] = bits;
          bits = 0;
          word = e >> 5;
        }
        bits |= 1u << (e & 31);
        e = n;
      }
      sbits[word] = bits;
      nwalk = 1;
      ex[1] = st[1] = (uint16_t)e;
    }
    // the id of the walk of this piece that visited e (e < end), or 0
    auto walk_of = [&](int e) -> int {
      const uint32_t bit = 1u << (e & 31);
      if (sbits[e >> 5] & bit) return 1;
      return fbits[e >> 5] & bit ? wd[e] : 0;
    };
    // a new walk of the piece from e (unvisited) -> its id; it never meets
    // itself, so its bits go to fbits a word at a time
    auto walk = [&](int e) {
      const int k = ++nwalk;
      int met = 0;
      int word = e >> 5;
      uint32_t bits = 0;
      while (e < end && (met = walk_of(e)) == 0) {
        wd[e] = (uint8_t)k;
        if ((e >> 5) != word) {
          fbits[word] |= bits;
          bits = 0;
          word = e >> 5;
        }
        bits |= 1u << (e & 31);
        e = nx[e];
      }
      fbits[word] |= bits;
      st[k] = (uint16_t)e;
      ex[k] = e < end ? ex[met] : (uint16_t)e;
      return k;
    };
    // a lane past the last piece passes the lane's end on
    int out = end ? ex[1] : seg_len;
    int entry = __shfl_up_sync(0xffffffffu, out, 1);
    if (p == 0) entry = 0;
    for (;;) {  // (3)
      if (entry < end) {
        int k = walk_of(entry);
        if (k == 0) k = walk(entry);
        out = ex[k];
      } else if (end) {
        out = entry;  // the chain jumps over the piece
      }
      int next_entry = __shfl_up_sync(0xffffffffu, out, 1);
      if (p == 0) next_entry = 0;
      if (!__any_sync(0xffffffffu, end && next_entry != entry)) break;
      entry = next_entry;
    }
    uint16_t* fr = s_from[p];  // (4)
    for (int k = 1; k <= nwalk; ++k) fr[k] = 0xFFFF;
    if (entry < end) {
      int f = entry;
      int k = walk_of(f);
      for (;;) {
        fr[k] = (uint16_t)f;
        f = st[k];
        if (f >= end) break;
        k = walk_of(f);
      }
    }
  }
  __syncthreads();
  // a thread a word (32 positions, one piece): the marks take the place of
  // the speculative walks' bits
  for (int w = tid; w < nwords; w += kTokThreads) {
    const int lo = 32 * w;
    const int p = lo >> lg_piece;
    const uint16_t* fr = s_from[p];
    const int from1 = fr[1];
    uint32_t m = sbits[w];
    m &= from1 <= lo ? ~0u : from1 >= lo + 32 ? 0u : ~0u << (from1 - lo);
    for (uint32_t f = fbits[w]; f; f &= f - 1) {
      const int i = __ffs(f) - 1;
      if (lo + i >= fr[wid[4 * p + lo + i]]) m |= 1u << i;
    }
    sbits[w] = m;
  }
  __syncthreads();

  store_marked(sbits, tok, seg, seg_len, tv + (int64_t)lane * seg,
               td + (int64_t)lane * seg, counts + lane);
}

// ---------------------------------------------------------------- fields
// One thread per token; the packed code | len << 16 tables in shared memory.
// The field is kept whole: a litlen code, up to 5 length-extra bits, a
// distance code and up to 13 distance-extra bits make up to 48 bits once
// codes reach 15 bits (15 + 5 + 15 + 13), so it leaves as a 64-bit word.
// Its low 32 bits are the reference kernel's 32-bit field, which drops
// what lies at bit 32 or above.

__device__ __forceinline__ int bitlen(int x, int kmax) {
  // floor(log2(x)) + 1 for x >= 1 (1 for x <= 1), saturating at kmax + 1
  return min(32 - __clz(max(x, 1)), kmax + 1);
}

__device__ __forceinline__ int len_symbol(int length) {
  int m = min(max(length - 3, 0), 255);
  int e = max(bitlen(m, 15) - 3, 0);
  int sym = m < 8 ? 257 + m : 257 + 4 * (e + 1) + ((m >> e) & 3);
  return length >= 258 ? 285 : sym;
}

__device__ __forceinline__ int dist_symbol(int dist) {
  int d1 = max(dist, 1) - 1;
  int k = max(bitlen(d1, 15) - 2, 0);
  return dist <= 4 ? d1 : 2 * (k + 1) + ((d1 >> k) & 1);
}

__global__ void encode_fields_kernel(const int32_t* __restrict__ tv_g,
                                     const int32_t* __restrict__ td_g,
                                     const int32_t* __restrict__ en_g,
                                     const int32_t* __restrict__ lt_g,
                                     const int32_t* __restrict__ dt_g,
                                     int64_t n, int64_t* __restrict__ val_out,
                                     int32_t* __restrict__ nb_out) {
  __shared__ int32_t lt[kLitlenSyms];
  __shared__ int32_t dt[kDistSyms];
  for (int i = threadIdx.x; i < kLitlenSyms; i += blockDim.x) lt[i] = lt_g[i];
  for (int i = threadIdx.x; i < kDistSyms; i += blockDim.x) dt[i] = dt_g[i];
  __syncthreads();
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int tv = tv_g[i];
  const int td = td_g[i];
  const bool en = en_g[i] > 0;
  const bool ism = en && td > 0;

  int lsym = ism ? len_symbol(min(max(tv, 3), 258)) : min(max(tv, 0), 287);
  int dsym = ism ? dist_symbol(min(max(td, 1), 32768)) : 0;
  int e1 = lt[lsym];
  uint32_t code1 = (uint32_t)(e1 & 0x7FFF);  // not masked by en
  int n1 = en ? (e1 >> 16) & 31 : 0;

  // length extra bits
  int m = min(max(tv - 3, 0), 255);
  int e = m < 8 ? 0 : max(bitlen(m, 15) - 3, 0);
  int base_m = m < 8 ? m : (4 + ((m >> e) & 3)) << e;
  bool has_len_extra = ism && tv < kMaxMatch;
  int len_en = has_len_extra ? e : 0;
  uint32_t len_ev = has_len_extra ? (uint32_t)(m - base_m) : 0u;

  int e3 = dt[dsym];
  uint32_t code3 = ism ? (uint32_t)(e3 & 0x7FFF) : 0u;
  int n3 = ism ? (e3 >> 16) & 31 : 0;

  // distance extra bits
  int d1 = max(td, 1) - 1;
  int kd = td <= 4 ? 0 : max(bitlen(d1, 15) - 2, 0);
  int base_d = td <= 4 ? d1 : (2 + ((d1 >> kd) & 1)) << kd;
  int dist_en = ism ? kd : 0;
  uint32_t dist_ev = ism ? (uint32_t)(d1 - base_d) : 0u;

  // the combined field, LSB-first: litlen code, length extra, dist code,
  // dist extra (n123 <= 35, so every shift stays inside the word)
  int n12 = n1 + len_en;
  int n123 = n12 + n3;
  uint64_t val = (uint64_t)code1 | ((uint64_t)len_ev << n1) |
                 ((uint64_t)code3 << n12) | ((uint64_t)dist_ev << n123);
  val_out[i] = (int64_t)val;
  nb_out[i] = n123 + dist_en;
}


// ---------------------------------------------------------------- tables
// block_tables: each block's coding choice and tables for the general
// encoder, bit for bit what the host planner (_plan_block,
// zlibes_tpu_torch/ops/block_tables.py) computes: the end-of-block count
// added, 15-bit litlen and distance lengths by package-merge, one distance
// code where no distance is used, the dynamic header (HLIT, HDIST, the
// 16/17/18 run-length coding, the 7-bit code-length code by package-merge,
// HCLEN), the exact dynamic, fixed and stored costs, the cheapest of the
// three, and the canonical bit-reversed codes of the chosen tables.  It
// runs between the symbols stage and the payload pack, which reads its
// tables where it left them.  The JAX package plans on the host: there is
// no Pallas counterpart.
//
// One block of 320 threads a DEFLATE block, a thread a symbol: warps 0-8
// the 288 litlen symbols, warp 9 the 32 distance symbols.
//
// Package-merge as package_merge_np does it: leaves in stable (frequency,
// symbol) order, a leaf before a package of equal weight, each round's
// packages the pairs of the round before's merged list.  A round is a
// parallel merge: a leaf's place is its rank plus the packages lighter than
// it, a package's its index plus the leaves no heavier, each found by
// binary search (a package's weight is the sum of two entries of the list
// before).  Both alphabets merge at once, one barrier a round.  The lengths
// follow from a backward walk over the rounds instead of count vectors: the
// first k entries of a round's list hold its first c leaves and k - c
// packages, and those packages are the pairs of the first 2 (k - c) entries
// of the round before; a leaf's length is the number of rounds whose
// prefix holds it, starting from the first 2n - 2 entries of the last.
//
// The header is built by warp 0 from shared memory: a start bit a run of
// equal code lengths (ballots), each run's 16/17/18 symbols counted into
// the code-length histogram, that alphabet's package-merge on the warp,
// then each run's bits placed by a warp scan of the runs' bit counts and
// OR-ed into 320 bytes of shared memory.  Costs are block reductions.
// Latency-bound: a few thousand dependent steps a block, every block of a
// dispatch at once.

constexpr int kTabThreads = kLitlenSyms + kDistSyms;  // a thread a symbol
constexpr int kTabWarps = kTabThreads / 32;
constexpr int kMaxBits = 15;           // litlen and distance code lengths
constexpr int kClcSyms = 19;           // the code-length alphabet
constexpr int kClcBits = 7;
constexpr int kEob = 256;
constexpr int kHdrWords = 80;          // 320 B: a header has <= 2,286 bits
constexpr int kInfo = 4 + kHdrWords / 2;  // int64 a block of ``info``
constexpr int kSeqWords = (kTabThreads + 1 + 31) / 32;  // run-start bits

__constant__ uint8_t kClcOrder[kClcSyms] = {16, 17, 18, 0, 8,  7, 9,
                                            6,  10, 5,  11, 4, 12, 3,
                                            13, 2,  14, 1,  15};

// One alphabet's package-merge state in shared memory: S symbols, M rounds.
struct PMerge {
  int64_t* leaf;      // (S,) sorted leaf weights
  int64_t* list[2];   // (2S,) the merged lists of odd and even rounds
  uint16_t* order;    // (S,) the symbol of sorted leaf j
  uint16_t* pkg_pos;  // (M, S) the place of package i in round r's list
  int* npk;           // (M,) packages of round r
  int* cut;           // (M,) leaves in the used prefix of round r's list
  int* n;             // used symbols
  int S;
};

template <int S, int M>
struct PMergeStore {
  int64_t leaf[S];
  int64_t list[2][2 * S];
  uint16_t order[S];
  uint16_t pkg_pos[M][S];
  int npk[M];
  int cut[M];
  int n;
  __device__ PMerge view() {
    return PMerge{leaf,   {list[0], list[1]}, order, &pkg_pos[0][0], npk,
                  cut,    &n,                 S};
  }
};

template <bool kWarp>
__device__ __forceinline__ void team_sync() {
  if (kWarp)
    __syncwarp();
  else
    __syncthreads();
}

// first index of a[0, n) holding a value >= x (kUpper: > x)
template <bool kUpper, typename T, typename Get>
__device__ __forceinline__ int search(int n, T x, Get a) {
  int lo = 0;
  while (n > 0) {
    const int h = n >> 1;
    const T v = a(lo + h);
    if (kUpper ? v <= x : v < x) {
      lo += h + 1;
      n -= h + 1;
    } else {
      n = h;
    }
  }
  return lo;
}

// Length-limited (M bits) code lengths of the histogram f (S,) into len,
// as package_merge_np computes them.  Thread t of a team of T takes symbols
// and list entries t, t + T, ...  Without kWarp every thread of the block
// calls it at once (the teams of both alphabets, each with its own state
// ``pm``: one instantiation, so every thread passes the same barrier
// instructions), M + 1 of them whatever the data; with kWarp one warp
// calls it.  Leaves len written, with no barrier after.
template <bool kWarp>
__device__ void package_merge(const PMerge& pm, const int64_t* f,
                              uint8_t* len, int t, int T, int M) {
  const int S = pm.S;
  int n = 0;
  for (int s = 0; s < S; ++s) n += f[s] > 0;
  for (int s = t; s < S; s += T) {
    len[s] = 0;
    const int64_t fs = f[s];
    if (fs > 0) {
      int r = 0;
      for (int u = 0; u < S; ++u) {
        const int64_t fu = f[u];
        r += fu > 0 && (fu < fs || (fu == fs && u < s));
      }
      pm.leaf[r] = fs;
      pm.list[0][r] = fs;
      pm.order[r] = (uint16_t)s;
    }
  }
  if (t == 0) *pm.n = n;
  team_sync<kWarp>();
  int size = n;
  for (int r = 1; r < M; ++r) {
    const int64_t* prev = pm.list[(r - 1) & 1];
    int64_t* cur = pm.list[r & 1];
    const int np = size >> 1;
    auto pkg = [&](int i) { return prev[2 * i] + prev[2 * i + 1]; };
    auto leaf = [&](int j) { return pm.leaf[j]; };
    for (int j = t; j < n; j += T) {
      const int64_t w = pm.leaf[j];
      cur[j + search<false>(np, w, pkg)] = w;
    }
    for (int i = t; i < np; i += T) {
      const int64_t w = pkg(i);
      const int p = i + search<true>(n, w, leaf);
      cur[p] = w;
      pm.pkg_pos[r * S + i] = (uint16_t)p;
    }
    if (t == 0) pm.npk[r] = np;
    size = n + np;
    team_sync<kWarp>();
  }
  if (t == 0 && n >= 2) {
    int k = min(2 * n - 2, size);
    for (int r = M - 1; r >= 1; --r) {
      const uint16_t* pos = pm.pkg_pos + r * S;
      const int p = search<false>(pm.npk[r], k, [&](int i) { return (int)pos[i]; });
      pm.cut[r] = k - p;
      k = 2 * p;
    }
    pm.cut[0] = k;
  }
  team_sync<kWarp>();
  for (int j = t; j < n; j += T) {
    int l = 1;
    if (n >= 2) {
      l = 0;
      for (int r = 0; r < M; ++r) l += j < pm.cut[r];
    }
    len[pm.order[j]] = (uint8_t)l;
  }
}

// The canonical code of symbol s under the lengths len (S,), bit-reversed
// for LSB-first packing; 0 for an unused symbol.
__device__ __forceinline__ uint32_t canonical_code(const uint8_t* len, int S,
                                                   int s) {
  const int l = len[s];
  if (l == 0) return 0;
  uint32_t code = 0;
  for (int u = 0; u < S; ++u) {
    const int lu = len[u];
    if (lu > 0 && lu < l) code += 1u << (l - lu);
    code += lu == l && u < s;
  }
  return __brev(code) >> (32 - l);
}

// The 16/17/18 run-length symbols of a run of ``run`` code lengths ``v``,
// as _rle_code_lengths emits them: emit(symbol, extra bits' value).
template <typename Emit>
__device__ __forceinline__ void rle_run(int v, int run, Emit emit) {
  int r = run;
  if (v == 0) {
    while (r >= 3) {
      if (r >= 11) {
        const int rep = min(r, 138);
        emit(18, rep - 11);
        r -= rep;
      } else {
        emit(17, r - 3);
        r = 0;
      }
    }
  } else {
    emit(v, 0);
    for (r = run - 1; r >= 3;) {
      const int rep = min(r, 6);
      emit(16, rep - 3);
      r -= rep;
    }
  }
  for (; r > 0; --r) emit(v, 0);
}

__device__ __forceinline__ int rle_extra_bits(int sym) {
  return sym == 16 ? 2 : sym == 17 ? 3 : sym == 18 ? 7 : 0;
}

// OR n <= 25 bits of v into the bit string words at bit ``off``
__device__ __forceinline__ void or_bits(uint32_t* words, int off, uint32_t v,
                                       int n) {
  const int sh = off & 31;
  atomicOr(&words[off >> 5], v << sh);
  if (sh + n > 32) atomicOr(&words[(off >> 5) + 1], v >> (32 - sh));
}

__device__ __forceinline__ int fixed_litlen_len(int s) {
  return s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8;
}

__device__ __forceinline__ int len_extra_of_symbol(int s) {  // 257..285
  const int i = s - 257;
  return (i < 8 || i == 28) ? 0 : (i - 4) >> 2;
}

__device__ __forceinline__ int64_t warp_sum64(int64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kTabThreads)
block_tables_kernel(const int64_t* __restrict__ ll_freq,
                    const int64_t* __restrict__ d_freq,
                    const int32_t* __restrict__ n_valid, int nblocks,
                    int final_block, int64_t* __restrict__ ll_code,
                    int64_t* __restrict__ ll_len, int64_t* __restrict__ d_code,
                    int64_t* __restrict__ d_len,
                    int64_t* __restrict__ hdr_bits_out,
                    uint8_t* __restrict__ enabled,
                    int64_t* __restrict__ info) {
  __shared__ int64_t s_f[kTabThreads];      // litlen, then distance counts
  __shared__ uint8_t s_len[kTabThreads];    // litlen, then distance lengths
  __shared__ PMergeStore<kLitlenSyms, kMaxBits> s_ll;
  __shared__ PMergeStore<kDistSyms, kMaxBits> s_d;
  __shared__ PMergeStore<kClcSyms, kClcBits> s_clc;
  __shared__ int64_t s_clc_f[kClcSyms];
  __shared__ uint8_t s_clc_len[kClcSyms];
  __shared__ uint32_t s_clc_code[kClcSyms];
  __shared__ uint32_t s_starts[kSeqWords];
  __shared__ uint32_t s_hdr[kHdrWords];
  __shared__ int64_t s_cost[2][kTabWarps];
  __shared__ int s_hlit, s_hdist, s_hdr_bits, s_btype;

  const int tid = threadIdx.x;
  const int ln = tid & 31;
  const int b = blockIdx.x;
  const bool is_ll = tid < kLitlenSyms;
  const int s = is_ll ? tid : tid - kLitlenSyms;  // this thread's symbol
  int64_t* code_out = is_ll ? ll_code + (int64_t)b * kLitlenSyms + s
                            : d_code + (int64_t)b * kDistSyms + s;
  int64_t* len_out = is_ll ? ll_len + (int64_t)b * kLitlenSyms + s
                           : d_len + (int64_t)b * kDistSyms + s;
  int64_t* info_b = info + (int64_t)b * kInfo;
  if (b >= nblocks) {  // padding: not coded
    *code_out = 0;
    *len_out = 0;
    if (tid < kInfo) info_b[tid] = 0;
    if (tid == 0) {
      hdr_bits_out[b] = 0;
      enabled[b] = 0;
    }
    return;
  }

  const int64_t f = is_ll ? ll_freq[(int64_t)b * kLitlenSyms + s] + (s == kEob)
                          : d_freq[(int64_t)b * kDistSyms + s];
  s_f[tid] = f;
  if (tid == 0) {
    s_hlit = 0;
    s_hdist = 0;
  }
  __syncthreads();

  // -- both alphabets' lengths at once
  const PMerge pm = is_ll ? s_ll.view() : s_d.view();
  package_merge<false>(pm, is_ll ? s_f : s_f + kLitlenSyms,
                       is_ll ? s_len : s_len + kLitlenSyms, s,
                       is_ll ? kLitlenSyms : kDistSyms, kMaxBits);
  __syncthreads();
  int l = s_len[tid];
  if (!is_ll && s == 0 && s_d.n == 0) {  // one distance code where none is used
    l = 1;
    s_len[tid] = 1;
  }
  if (l > 0) atomicMax(is_ll ? &s_hlit : &s_hdist, s + 1);

  // -- payload costs, extra bits included: dynamic and fixed
  int64_t extra = 0;
  if (is_ll && s >= 257 && s <= 285) extra = f * len_extra_of_symbol(s);
  if (!is_ll && s < 30) extra = f * (s < 4 ? 0 : (s - 2) >> 1);
  const int64_t dyn = warp_sum64(f * l + extra);
  const int64_t fix =
      warp_sum64(f * (is_ll ? fixed_litlen_len(s) : 5) + extra);
  if (ln == 0) {
    s_cost[0][tid >> 5] = dyn;
    s_cost[1][tid >> 5] = fix;
  }
  __syncthreads();

  // -- the dynamic header, on warp 0
  if (tid < 32) {
    const int hlit = max(257, s_hlit);
    const int hdist = max(1, s_hdist);
    const int n_all = hlit + hdist;
    auto seq = [&](int i) {
      return (int)(i < hlit ? s_len[i] : s_len[kLitlenSyms + i - hlit]);
    };
    for (int c = 0; c < kSeqWords; ++c) {  // run starts, and one at n_all
      const int i = 32 * c + ln;
      const bool st =
          i == n_all || (i < n_all && (i == 0 || seq(i) != seq(i - 1)));
      const uint32_t m = __ballot_sync(0xffffffffu, st);
      if (ln == 0) s_starts[c] = m;
    }
    if (ln < kClcSyms) s_clc_f[ln] = 0;
    for (int w = ln; w < kHdrWords; w += 32) s_hdr[w] = 0;
    __syncwarp();
    // the run from start i: its value and length
    auto run_at = [&](int i, int& v, int& run) {
      int c = i >> 5;
      uint32_t m = s_starts[c] & ~((2u << (i & 31)) - 1u);
      while (m == 0) m = s_starts[++c];
      v = seq(i);
      run = 32 * c + __ffs(m) - 1 - i;
    };
    for (int i = ln; i < n_all; i += 32) {
      if ((s_starts[i >> 5] >> (i & 31)) & 1u) {
        int v, run;
        run_at(i, v, run);
        rle_run(v, run, [&](int sym, int) {
          atomicAdd(reinterpret_cast<unsigned long long*>(&s_clc_f[sym]),
                    1ull);
        });
      }
    }
    __syncwarp();
    package_merge<true>(s_clc.view(), s_clc_f, s_clc_len, ln, 32, kClcBits);
    __syncwarp();
    if (ln < kClcSyms) s_clc_code[ln] = canonical_code(s_clc_len, kClcSyms, ln);
    const uint32_t sent =
        __ballot_sync(0xffffffffu, ln < kClcSyms && s_clc_len[kClcOrder[ln]]);
    const int hclen = max(4, 32 - __clz(sent));
    if (ln == 0)
      or_bits(s_hdr, 0,
              (b == final_block) | (2u << 1) | ((uint32_t)(hlit - 257) << 3) |
                  ((uint32_t)(hdist - 1) << 8) | ((uint32_t)(hclen - 4) << 13),
              17);
    if (ln < hclen) or_bits(s_hdr, 17 + 3 * ln, s_clc_len[kClcOrder[ln]], 3);
    __syncwarp();
    int bit = 17 + 3 * hclen;
    for (int c = 0; 32 * c < n_all; ++c) {  // the runs a chunk, in order
      const int i = 32 * c + ln;
      const bool st = i < n_all && ((s_starts[c] >> ln) & 1u);
      int v = 0, run = 0, nb = 0;
      if (st) {
        run_at(i, v, run);
        rle_run(v, run, [&](int sym, int) {
          nb += s_clc_len[sym] + rle_extra_bits(sym);
        });
      }
      const int incl = warp_inclusive_sum(nb);
      if (st) {
        int off = bit + incl - nb;
        rle_run(v, run, [&](int sym, int x) {
          const int cl = s_clc_len[sym];
          or_bits(s_hdr, off, s_clc_code[sym], cl);
          off += cl;
          const int xb = rle_extra_bits(sym);
          if (xb) or_bits(s_hdr, off, (uint32_t)x, xb);
          off += xb;
        });
      }
      bit += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (ln == 0) {
      // the cheapest of stored, fixed and dynamic
      int64_t dyn_bits = bit + s_len[kEob], fix_bits = 3 + 7;
      for (int w = 0; w < kTabWarps; ++w) {
        dyn_bits += s_cost[0][w];
        fix_bits += s_cost[1][w];
      }
      const int64_t nb = n_valid[b];
      const int64_t stored = nb + 5 * ((nb + 65534) / 65535);
      const int64_t best = fix_bits < dyn_bits ? fix_bits : dyn_bits;
      s_btype = stored < best / 8 ? 0 : fix_bits <= dyn_bits ? 1 : 2;
      s_hdr_bits = bit;
    }
  }
  __syncthreads();

  // -- the chosen tables, their codes, and what the host splices
  const int btype = s_btype;
  if (btype == 1) {
    s_len[tid] = (uint8_t)(is_ll ? fixed_litlen_len(s) : 5);
    if (tid == 0) s_hdr_bits = 3;
    if (tid < kHdrWords) s_hdr[tid] = tid == 0 ? (b == final_block) | (1u << 1) : 0;
  }
  __syncthreads();
  const bool coded = btype != 0;
  const int lc = coded ? s_len[tid] : 0;
  const uint32_t code =
      coded ? canonical_code(is_ll ? s_len : s_len + kLitlenSyms,
                             is_ll ? kLitlenSyms : kDistSyms, s)
            : 0u;
  *code_out = code;
  *len_out = lc;
  if (tid == kEob) {
    info_b[1] = code;
    info_b[2] = lc;
  }
  if (tid == 0) {
    const int hb = coded ? s_hdr_bits : 0;
    hdr_bits_out[b] = hb;
    enabled[b] = coded;
    info_b[0] = btype;
    info_b[3] = hb;
  }
  if (tid < kHdrWords / 2)
    info_b[4 + tid] =
        coded ? (int64_t)(((uint64_t)s_hdr[2 * tid + 1] << 32) | s_hdr[2 * tid])
              : 0;
}

}  // namespace

extern "C" {

int zt_select_turbo(const void* pv, const void* seg_len, int lanes, int lazy,
                    int split_far, void* toks, void* counts, void* stream) {
  unsigned blocks = (unsigned)((lanes + kSelLanes - 1) / kSelLanes);
  auto kernel = split_far ? select_turbo_kernel<true>
                          : select_turbo_kernel<false>;
  kernel<<<blocks, kSelThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pv, (const int32_t*)seg_len, lanes, lazy,
      (int32_t*)toks, (int32_t*)counts);
  return (int)cudaGetLastError();
}

int zt_select_tokens(const void* data, int64_t pitch, const void* matches,
                     const void* n_valid, int N, int nseg, int seg, int start,
                     int lazy, int split_far, int lanes, void* tv, void* td,
                     void* counts, void* stream) {
  if (seg <= 0 || seg > kMaxTokSeg) return (int)cudaErrorInvalidValue;
  auto kernel = split_far ? select_tokens_kernel<true>
                          : select_tokens_kernel<false>;
  const int smem = select_tokens_smem(seg);
  // the default cap of 48 KB counts the 8.6 KB of static tables too
  if (smem > 32 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  kernel<<<(unsigned)lanes, kTokThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, pitch, (const int32_t*)matches,
      (const int32_t*)n_valid, N, nseg, seg, start, lazy, (int32_t*)tv,
      (int32_t*)td, (int32_t*)counts);
  return (int)cudaGetLastError();
}

int zt_encode_fields(const void* tv, const void* td, const void* en,
                     const void* lt, const void* dt, int64_t n, void* val,
                     void* nb, void* stream) {
  const int threads = 256;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  encode_fields_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tv, (const int32_t*)td, (const int32_t*)en,
      (const int32_t*)lt, (const int32_t*)dt, n, (int64_t*)val, (int32_t*)nb);
  return (int)cudaGetLastError();
}

int zt_block_tables(const void* ll_freq, const void* d_freq,
                    const void* n_valid, int blocks, int nblocks,
                    int final_block, void* ll_code, void* ll_len,
                    void* d_code, void* d_len, void* hdr_bits, void* enabled,
                    void* info, void* stream) {
  block_tables_kernel<<<(unsigned)blocks, kTabThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int64_t*)ll_freq, (const int64_t*)d_freq,
      (const int32_t*)n_valid, nblocks, final_block, (int64_t*)ll_code,
      (int64_t*)ll_len, (int64_t*)d_code, (int64_t*)d_len,
      (int64_t*)hdr_bits, (uint8_t*)enabled, (int64_t*)info);
  return (int)cudaGetLastError();
}

}  // extern "C"
