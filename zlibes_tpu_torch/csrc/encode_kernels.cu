// Encode kernels for Hopper (sm_90a).
//
// select_turbo (zlibes_tpu_torch/ops/turbo_kernel.py), select_tokens
// (zlibes_tpu_torch/ops/lz77.py) and encode_fields
// (zlibes_tpu_torch/ops/encode_kernel.py), each with a plain extern "C"
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

}  // extern "C"
