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

}  // extern "C"
