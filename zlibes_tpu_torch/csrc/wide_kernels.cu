// Default-profile (wide) inflate kernels for Hopper (sm_90a).
//
// One kernel per stage of zlibes_tpu_torch/ops/wide_kernel.py, each with a
// plain extern "C" launcher that takes device pointers and a CUDA stream,
// launches on that stream, and returns cudaGetLastError().  The Python
// wrappers check shapes, types and devices and allocate every output; the
// plain PyTorch versions beside them define the same results.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -c -Xcompiler -fPIC -o wide_kernels.o wide_kernels.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSub = 128;           // SUB: bytes per lane / sub-span
constexpr int kLlRootBits = 9;      // LL_ROOT_BITS
constexpr int kLlRoot = 1 << kLlRootBits;
constexpr int kLlSub = 512;         // LL_SUB
constexpr int kLlW = kLlRoot + kLlSub;
constexpr int kDRootBits = 6;       // D_ROOT_BITS
constexpr int kDRoot = 1 << kDRootBits;
constexpr int kDSubOff = 128;       // D_SUB_OFF
constexpr int kDW = kDSubOff + 640; // D_W
constexpr int kSubFlag = 1 << 30;
constexpr int kWindow = 32768;      // RFC 1951 window
constexpr int kMatchBit = 1 << 25;  // TOK_MATCH_BIT
constexpr int kTokensPad = 256;     // TOKENS_PAD: slots per sub-span
constexpr int kFlag = 1 << 30;      // resolved-byte flag
constexpr int kTile = 4096;         // resolve tile (bytes)
constexpr int kJumpRounds = 12;     // 2^12 >= longest chain in one tile

constexpr int kKindEob = 1, kKindLen = 2, kKindInvalid = 3;

// ---------------------------------------------------------------- decode
// One thread per lane, running until its own lane ends.  A block's 128
// lanes lie in one block row, whose tables it keeps in shared memory.

constexpr int kDecodeThreads = 128;

__global__ void __launch_bounds__(kDecodeThreads)
decode_wide_kernel(const int32_t* __restrict__ win, int sw,
                   const int32_t* __restrict__ bit0,
                   const int32_t* __restrict__ endb,
                   const int32_t* __restrict__ base,
                   const int32_t* __restrict__ lt_g,
                   const int32_t* __restrict__ dt_g, int lanes, int lpb,
                   int max_tokens, int32_t* __restrict__ tokens,
                   int32_t* __restrict__ starts, int32_t* __restrict__ meta) {
  __shared__ int32_t lt[kLlW];
  __shared__ int32_t dt[kDW];
  const int first = blockIdx.x * kDecodeThreads;
  const int64_t row = first / lpb;
  for (int i = threadIdx.x; i < kLlW; i += kDecodeThreads)
    lt[i] = lt_g[row * kLlW + i];
  for (int i = threadIdx.x; i < kDW; i += kDecodeThreads)
    dt[i] = dt_g[row * kDW + i];
  __syncthreads();
  const int l = first + threadIdx.x;
  if (l >= lanes) return;

  const uint32_t* w =
      reinterpret_cast<const uint32_t*>(win) + (int64_t)l * sw;
  // the lane's sub-span offset in its block: no distance reaches further
  const int span0 = (l % lpb) * kSub;
  int pos = bit0[l];
  const int end = endb[l];
  int outpos = base[l];
  bool active = pos < end;
  int err = 0;
  int count = 0;
  int last_tok = 0;
  int last_start = 0;
  for (int t = 0; t < max_tokens && active; ++t) {
    // the 64 stream bits starting at bit pos (LSB-first); reads past the
    // window's last word clamp to it
    const int wi = pos >> 5;
    const int s = pos & 31;
    const uint32_t w0 = w[min(wi, sw - 1)];
    const uint32_t w1 = w[min(wi + 1, sw - 1)];
    const uint32_t w2 = w[min(wi + 2, sw - 1)];
    uint64_t x = ((uint64_t)w0 | ((uint64_t)w1 << 32)) >> s;
    if (s) x |= (uint64_t)w2 << (64 - s);

    // litlen symbol: 9-bit root, sub-table on long-code prefixes
    const int e1 = lt[x & (kLlRoot - 1)];
    int e = e1;
    if (e1 & kSubFlag) {
      const int subw = min(e1 & 15, 6);
      int sidx = ((e1 >> 9) & 511) +
                 (int)((x >> kLlRootBits) & ((1u << subw) - 1u));
      e = lt[kLlRoot + min(max(sidx, 0), kLlSub - 1)];
    }
    const int ln = e & 15;
    const int kind = (e >> 4) & 3;
    const int eb = (e >> 6) & 7;
    const bool is_len = kind == kKindLen;
    int val = (e >> 9) & 511;
    if (is_len) val += (int)((x >> ln) & ((1u << eb) - 1u));
    const int k1 = ln + eb;
    const uint64_t y = x >> k1;

    // distance symbol: 6-bit root + sub region
    const int d1 = dt[y & (kDRoot - 1)];
    int de = d1;
    if (d1 & kSubFlag) {
      const int dsw = min((d1 >> 24) & 15, 9);
      int dsidx = ((d1 >> 8) & 1023) +
                  (int)((y >> kDRootBits) & ((1u << dsw) - 1u));
      de = dt[kDSubOff + min(max(dsidx, 0), 639)];
    }
    const int dln = de & 15;
    const int deb = (de >> 4) & 15;
    const int dist =
        ((de >> 8) & 0x7FFF) + (int)((y >> dln) & ((1u << deb) - 1u));

    const int newpos = pos + k1 + (is_len ? dln + deb : 0);
    const bool bad =
        ln == 0 || kind == kKindInvalid ||
        (is_len && (dln == 0 || dist > kWindow || dist > span0 + outpos)) ||
        newpos > end;
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
    const int tok = is_len ? (val | (dist << 9) | kMatchBit) : val;
    tokens[(int64_t)t * lanes + l] = tok;
    starts[(int64_t)t * lanes + l] = outpos;
    last_tok = tok;
    last_start = outpos;
    outpos += is_len ? val : 1;
    ++count;
    active = newpos < end;
  }
  meta[l] = count;
  meta[(int64_t)lanes + l] = pos;
  meta[2 * (int64_t)lanes + l] = err;
  meta[3 * (int64_t)lanes + l] = active ? 1 : 0;
  meta[4 * (int64_t)lanes + l] = last_tok;
  meta[5 * (int64_t)lanes + l] = last_start;
}

// ---------------------------------------------------------------- resolve
// One block per block row, walking the row in 4 KiB tiles, in order.  A
// tile's unresolved bytes live in shared memory as local pointers; a
// source in an earlier tile is read from the row's output, which the
// barrier closing the previous tile has made visible.

constexpr int kResolveThreads = 1024;
constexpr int kBytesPerThread = kTile / kResolveThreads;

__global__ void __launch_bounds__(kResolveThreads)
resolve_wide_kernel(const int32_t* __restrict__ toks,
                    const int32_t* __restrict__ starts, int nsubb,
                    uint8_t* out) {
  __shared__ int32_t state[kTile];
  const int64_t n = (int64_t)nsubb * kSub;
  const int64_t row = blockIdx.x;
  const int32_t* tr = toks + row * nsubb * kTokensPad;
  const int32_t* sr = starts + row * nsubb * kTokensPad;
  uint8_t* o = out + row * n;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    for (int k = 0; k < kBytesPerThread; ++k) {
      const int ql = threadIdx.x + k * kResolveThreads;
      const int q = t0 + ql;
      const int m = q / kSub;
      const int qs = q % kSub;
      const int32_t* sp = sr + (int64_t)m * kTokensPad;
      // largest slot with start <= qs (slot 0 when none): branch-free
      int lo = 0;
      for (int step = kTokensPad / 2; step; step >>= 1)
        if (sp[lo + step] <= qs) lo += step;
      const int tok = tr[(int64_t)m * kTokensPad + lo];
      const int dist = (tok >> 9) & 0xFFFF;
      int v;
      if (tok & kMatchBit) {
        const int src = (int)min(max((int64_t)q - dist, (int64_t)0), n - 1);
        v = src < t0 ? (o[src] | kFlag) : src - t0;
      } else {
        v = (tok & 255) | kFlag;
      }
      state[ql] = v;
    }
    __syncthreads();
    // pointer jumping: every unresolved byte points at an earlier one (or
    // at itself); stop once a round changes nothing
    for (int r = 0; r < kJumpRounds; ++r) {
      int next[kBytesPerThread];
      int changed = 0;
      for (int k = 0; k < kBytesPerThread; ++k) {
        const int v = state[threadIdx.x + k * kResolveThreads];
        next[k] = (v & kFlag) ? v : state[v];
        changed |= next[k] != v;
      }
      __syncthreads();
      for (int k = 0; k < kBytesPerThread; ++k)
        state[threadIdx.x + k * kResolveThreads] = next[k];
      if (!__syncthreads_or(changed)) break;
    }
    for (int k = 0; k < kBytesPerThread; ++k) {
      const int ql = threadIdx.x + k * kResolveThreads;
      o[t0 + ql] = (uint8_t)(state[ql] & 255);
    }
    // the tile's bytes are visible to the next tile's far reads, and its
    // state may be overwritten
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int zt_decode_wide(const void* win, int sw, const void* bit0,
                   const void* endb, const void* base, const void* lt,
                   const void* dt, int lanes, int lpb, int max_tokens,
                   void* tokens, void* starts, void* meta, void* stream) {
  unsigned blocks = (unsigned)((lanes + kDecodeThreads - 1) / kDecodeThreads);
  decode_wide_kernel<<<blocks, kDecodeThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)win, sw, (const int32_t*)bit0, (const int32_t*)endb,
      (const int32_t*)base, (const int32_t*)lt, (const int32_t*)dt, lanes,
      lpb, max_tokens, (int32_t*)tokens, (int32_t*)starts, (int32_t*)meta);
  return (int)cudaGetLastError();
}

int zt_resolve_wide(const void* toks, const void* starts, int rows,
                    int nsubb, void* out, void* stream) {
  resolve_wide_kernel<<<(unsigned)rows, kResolveThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)toks, (const int32_t*)starts, nsubb, (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
