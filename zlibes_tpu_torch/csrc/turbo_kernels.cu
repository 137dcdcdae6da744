// Turbo-profile inflate kernels for Hopper (sm_90a).
//
// One kernel per stage of zlibes_tpu_torch/ops/turbo_kernel.py, each with a
// plain extern "C" launcher that takes device pointers and a CUDA stream,
// launches on that stream, and returns cudaGetLastError().  The Python
// wrappers check shapes, types and devices and allocate every output; the
// plain PyTorch versions beside them define the same results.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -c -Xcompiler -fPIC -o turbo_kernels.o turbo_kernels.cu
// (runtime/kernels.py links it with the other sources into one library)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStreamWords = 96;   // STREAM_WORDS
constexpr int kTable = 512;        // TABLE (9-bit codes)
constexpr int kChunk = 4096;       // bytes per resolve chunk row
constexpr int kSub = 256;          // SUB: bytes per resolve sub-span
constexpr int kSubsPerChunk = kChunk / kSub;
constexpr int kTokensPad = 384;    // TOKENS_PAD: slots per sub-span
constexpr int kDistMask = 0xFFF;   // TOK_DIST_MASK
constexpr int kMatchBit = 1 << 21; // TOK_MATCH_BIT
constexpr int kFlag = 1 << 30;     // resolved-byte flag
constexpr int kJumpRounds = 12;    // 2^12 >= longest chain in 4096 bytes

constexpr int kKindEob = 1, kKindLen = 2, kKindInvalid = 3;

// ---------------------------------------------------------------- windows
// out[l, w] = words[start_w[l] + w] for w < width, 0 past the end of the
// stream.

__global__ void lane_windows_kernel(const int32_t* __restrict__ words,
                                    int64_t nwords,
                                    const int32_t* __restrict__ start_w,
                                    int64_t lanes, int width,
                                    int32_t* __restrict__ out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes * width) return;
  int64_t l = i / width;
  int64_t idx = (int64_t)start_w[l] + (i - l * width);
  out[i] = (idx >= 0 && idx < nwords) ? words[idx] : 0;
}

// ---------------------------------------------------------------- decode
// One thread per lane, running until its own lane ends.

__device__ __forceinline__ uint32_t window_word(const uint32_t* w, int i) {
  return w[i < kStreamWords ? i : kStreamWords - 1];
}

__global__ void decode_turbo_kernel(const int32_t* __restrict__ win,
                                    const int32_t* __restrict__ bit0,
                                    const int32_t* __restrict__ endb,
                                    const int32_t* __restrict__ lt_g,
                                    const int32_t* __restrict__ dt_g,
                                    int lanes, int max_tokens,
                                    int32_t* __restrict__ tokens,
                                    int32_t* __restrict__ meta) {
  __shared__ int32_t lt[kTable];
  __shared__ int32_t dt[kTable];
  for (int i = threadIdx.x; i < kTable; i += blockDim.x) {
    lt[i] = lt_g[i];
    dt[i] = dt_g[i];
  }
  __syncthreads();
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;

  const uint32_t* w =
      reinterpret_cast<const uint32_t*>(win) + (int64_t)l * kStreamWords;
  int pos = bit0[l];
  const int end = endb[l];
  bool active = pos < end;
  int err = 0;
  int count = 0;
  for (int t = 0; t < max_tokens && active; ++t) {
    // the 64 stream bits starting at bit pos (LSB-first); a token uses at
    // most 9 + 7 + 9 + 15 of them
    int wi = pos >> 5;
    int s = pos & 31;
    uint64_t x = (uint64_t)window_word(w, wi) |
                 ((uint64_t)window_word(w, wi + 1) << 32);
    x >>= s;
    if (s) x |= (uint64_t)window_word(w, wi + 2) << (64 - s);

    int e = lt[x & (kTable - 1)];
    int ln = e & 15;
    int kind = (e >> 4) & 3;
    int eb = (e >> 6) & 7;
    int base = (e >> 9) & 511;
    int extra = (int)((x >> ln) & ((1u << eb) - 1u));
    bool is_len = kind == kKindLen;
    int val = is_len ? base + extra : base;
    int k1 = ln + eb;
    uint64_t y = x >> k1;
    int de = dt[y & (kTable - 1)];
    int dln = de & 15;
    int deb = (de >> 4) & 15;
    int dist = ((de >> 8) & 0x7FFF) + (int)((y >> dln) & ((1u << deb) - 1u));
    int newpos = pos + k1 + (is_len ? dln + deb : 0);
    bool bad = ln == 0 || kind == kKindInvalid ||
               (is_len && (dln == 0 || dist > kDistMask)) || newpos > end;
    if (bad) {
      err = 1;
      active = false;
      break;
    }
    pos = newpos;
    if (kind == kKindEob) {
      active = false;
      break;
    }
    tokens[(int64_t)t * lanes + l] =
        is_len ? (val | (dist << 9) | kMatchBit) : val;
    ++count;
    active = newpos < end;
  }
  meta[l] = count;
  meta[(int64_t)lanes + l] = pos;
  meta[2 * (int64_t)lanes + l] = err;
  meta[3 * (int64_t)lanes + l] = active ? 1 : 0;
}

// ---------------------------------------------------------------- resolve
// One block per 4 KiB chunk row; the row's state lives in shared memory.

constexpr int kResolveThreads = 512;
constexpr int kBytesPerThread = kChunk / kResolveThreads;

__global__ void __launch_bounds__(kResolveThreads)
resolve_turbo_kernel(const int32_t* __restrict__ toks,
                     const int32_t* __restrict__ starts, int rows,
                     uint8_t* __restrict__ out) {
  __shared__ int32_t state[kChunk];
  const int c = blockIdx.x;
  for (int k = 0; k < kBytesPerThread; ++k) {
    int q = threadIdx.x + k * kResolveThreads;
    int m = q / kSub;
    int ql = q % kSub;
    int64_t row = ((int64_t)m * rows + c) * kTokensPad;
    const int32_t* sp = starts + row;
    // largest slot with start <= ql (slot 0 when none): branch-free search
    int lo = 0;
    for (int step = 256; step; step >>= 1) {
      int mid = lo + step;
      if (mid < kTokensPad && sp[mid] <= ql) lo = mid;
    }
    int tok = toks[row + lo];
    int val = tok & 0x1FF;
    int dist = (tok >> 9) & kDistMask;
    int src = min(max(q - dist, 0), kChunk - 1);
    state[q] = (tok & kMatchBit) ? src : ((val & 255) | kFlag);
  }
  __syncthreads();
  // pointer jumping: every unresolved byte points at an earlier one
  for (int r = 0; r < kJumpRounds; ++r) {
    int next[kBytesPerThread];
    for (int k = 0; k < kBytesPerThread; ++k) {
      int v = state[threadIdx.x + k * kResolveThreads];
      next[k] = (v & kFlag) ? v : state[v];
    }
    __syncthreads();
    for (int k = 0; k < kBytesPerThread; ++k)
      state[threadIdx.x + k * kResolveThreads] = next[k];
    __syncthreads();
  }
  uint8_t* o = out + (int64_t)c * kChunk;
  for (int k = 0; k < kBytesPerThread; ++k) {
    int q = threadIdx.x + k * kResolveThreads;
    o[q] = (uint8_t)(state[q] & 255);
  }
}

static_assert(kSubsPerChunk * kSub == kChunk, "chunk = 16 sub-spans");

}  // namespace

extern "C" {

int zt_lane_windows(const void* words, int64_t nwords, const void* start_w,
                    int64_t lanes, int width, void* out, void* stream) {
  const int threads = 256;
  int64_t n = lanes * width;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  lane_windows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, nwords, (const int32_t*)start_w, lanes, width,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

int zt_decode_turbo(const void* win, const void* bit0, const void* endb,
                    const void* lt, const void* dt, int lanes, int max_tokens,
                    void* tokens, void* meta, void* stream) {
  const int threads = 128;
  unsigned blocks = (unsigned)((lanes + threads - 1) / threads);
  decode_turbo_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)win, (const int32_t*)bit0, (const int32_t*)endb,
      (const int32_t*)lt, (const int32_t*)dt, lanes, max_tokens,
      (int32_t*)tokens, (int32_t*)meta);
  return (int)cudaGetLastError();
}

int zt_resolve_turbo(const void* toks, const void* starts, int rows,
                     void* out, void* stream) {
  resolve_turbo_kernel<<<(unsigned)rows, kResolveThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)toks, (const int32_t*)starts, rows, (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
