// Turbo-profile encode kernels for Hopper (sm_90a).
//
// select_turbo (zlibes_tpu_torch/ops/turbo_kernel.py) and encode_fields
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
// order.  Far matches (dist > 2048) are capped at 130 bytes, as the
// reference's split_far does for codes of at most 9 bits: the only codes
// the port encodes.
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
__device__ __forceinline__ int select_step(int cur, int nxt, int c,
                                           int seg_end, int lazy) {
  int ml = (cur >> kLenShift) & 511;
  const int dist = cur & 0xFFF;
  const int lit = (cur >> kLitShift) & 0xFF;
  ml = min(ml, seg_end - c);
  if (ml >= 131 && dist >= 2049) ml = 130;
  bool use = ml >= kMinMatch;
  if (lazy && use && ml < kMaxMatch && c + 1 < seg_end) {
    const int ml1 = (nxt >> kLenShift) & 511;
    if (ml1 > ml) use = false;
  }
  const int tok = use ? (ml | (dist << kDistShift) | kMatchBit) : lit;
  const int next = c + (use ? ml : 1);
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
    packed[r].x = select_step(cur.x, cur.y, c, seg_end, lazy);
    packed[r].y = select_step(cur.y, cur.z, c + 1, seg_end, lazy);
    packed[r].z = select_step(cur.z, cur.w, c + 2, seg_end, lazy);
    packed[r].w = select_step(cur.w, after, c + 3, seg_end, lazy);
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
