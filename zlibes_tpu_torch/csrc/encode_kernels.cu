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

// select_turbo: 512-position lanes, distances of 12 bits, split_far on (the
// turbo profile's codes have at most 9 bits).
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
__device__ __forceinline__ int turbo_step(int cur, int nxt, int c,
                                          int seg_end, int lazy) {
  int tok, next;
  select_step<true, kMatchBit>(
      (cur >> kLenShift) & 511, cur & 0xFFF, (cur >> kLitShift) & 0xFF,
      [nxt] { return (nxt >> kLenShift) & 511; }, c, seg_end, lazy, tok, next);
  return tok | (int)((unsigned)next << kNextShift);
}

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
    packed[r].x = turbo_step(cur.x, cur.y, c, seg_end, lazy);
    packed[r].y = turbo_step(cur.y, cur.z, c + 1, seg_end, lazy);
    packed[r].z = turbo_step(cur.z, cur.w, c + 2, seg_end, lazy);
    packed[r].w = turbo_step(cur.w, after, c + 3, seg_end, lazy);
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

// select_tokens: the general encoder's selection (levels 1-9).  Lanes of a
// run-time length ``seg`` (4,096 by default), distances to 32,768, no
// split_far, and a row offset ``start`` (the width of a preset dictionary's
// context prefix, whose positions are match sources and never tokens).
// Reads the matcher's (len << 16) | dist and the block's bytes as they are.
//
// One block a lane, the lane's row in shared memory as (token, next) pairs:
// a wide token takes 26 bits (val 9 | dist 16 << 9 | match bit 25), so the
// successor does not fit beside it in one word as in select_turbo.  (1) All
// threads compute every position's token and successor at once, neighbouring
// threads on neighbouring positions.  (2) Thread 0 walks the chain from
// position 0, one 8-byte shared-memory load a step, writing token t in place
// at slot t <= cursor.  (3) All threads store the two output rows, zeros
// past the count.  Bound by the latency of the longest lane's chain (at most
// ``seg`` steps, an all-literal lane); a dispatch of 16 blocks has 512 lanes,
// all resident at once.

constexpr int kTokThreads = 256;
constexpr int kWideMatchBit = 1 << 25;

__global__ void __launch_bounds__(kTokThreads)
select_tokens_kernel(const uint8_t* __restrict__ data, int64_t pitch,
                     const int32_t* __restrict__ matches,
                     const int32_t* __restrict__ n_valid, int N, int nseg,
                     int seg, int start, int lazy, int32_t* __restrict__ tv,
                     int32_t* __restrict__ td, int32_t* __restrict__ counts) {
  extern __shared__ int2 tok_row[];  // seg pairs: .x token, .y next position
  __shared__ int s_tok_count;
  const int lane = blockIdx.x;
  const int b = lane / nseg;
  const int seg0 = start + (lane % nseg) * seg;
  const int seg_len = min(max(n_valid[b] - seg0, 0), seg);
  const int32_t* m = matches + (int64_t)b * N + seg0;
  const uint8_t* d = data + (int64_t)b * pitch + seg0;

  for (int c = threadIdx.x; c < seg_len; c += kTokThreads) {
    const int cur = m[c];
    int2 w;
    select_step<false, kWideMatchBit>(
        cur >> 16, cur & 0xFFFF, d[c], [m, c] { return m[c + 1] >> 16; }, c,
        seg_len, lazy, w.x, w.y);
    tok_row[c] = w;
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    int c = 0;
    int t = 0;
    while (c < seg_len) {
      const int2 w = tok_row[c];
      tok_row[t++].x = w.x;
      c = w.y;
    }
    s_tok_count = t;
    counts[lane] = t;
  }
  __syncthreads();

  const int cnt = s_tok_count;
  int32_t* tv_row = tv + (int64_t)lane * seg;
  int32_t* td_row = td + (int64_t)lane * seg;
  for (int c = threadIdx.x; c < seg; c += kTokThreads) {
    // a literal has no bit above its byte, so both fields read as they lie
    const int w = c < cnt ? tok_row[c].x : 0;
    tv_row[c] = w & 0x1FF;
    td_row[c] = (w >> kDistShift) & 0xFFFF;
  }
}

// ---------------------------------------------------------------- fields
// One thread per token; the packed code | len << 16 tables in shared memory.

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
                                     int64_t n, int32_t* __restrict__ val_out,
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
  // dist extra; a field starting at bit 32 or later is dropped
  int n12 = n1 + len_en;
  int n123 = n12 + n3;
  uint32_t val = code1 | (len_ev << n1);
  if (n12 < 32) val |= code3 << n12;
  if (n123 < 32) val |= dist_ev << n123;
  val_out[i] = (int32_t)val;
  nb_out[i] = n123 + dist_en;
}

}  // namespace

extern "C" {

int zt_select_turbo(const void* pv, const void* seg_len, int lanes, int lazy,
                    void* toks, void* counts, void* stream) {
  unsigned blocks = (unsigned)((lanes + kSelLanes - 1) / kSelLanes);
  select_turbo_kernel<<<blocks, kSelThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pv, (const int32_t*)seg_len, lanes, lazy,
      (int32_t*)toks, (int32_t*)counts);
  return (int)cudaGetLastError();
}

int zt_select_tokens(const void* data, int64_t pitch, const void* matches,
                     const void* n_valid, int N, int nseg, int seg, int start,
                     int lazy, int lanes, void* tv, void* td, void* counts,
                     void* stream) {
  const int smem = seg * (int)sizeof(int2);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        select_tokens_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  select_tokens_kernel<<<(unsigned)lanes, kTokThreads, smem,
                         (cudaStream_t)stream>>>(
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
      (const int32_t*)lt, (const int32_t*)dt, n, (int32_t*)val, (int32_t*)nb);
  return (int)cudaGetLastError();
}

}  // extern "C"
