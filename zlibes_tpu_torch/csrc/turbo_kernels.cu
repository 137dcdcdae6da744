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

#include "lane_decode.cuh"

namespace {

using namespace lane_decode;

constexpr int kStreamWords = 96;   // STREAM_WORDS
constexpr int kTable = 512;        // TABLE (9-bit codes)
constexpr int kChunk = 4096;       // bytes per resolve chunk row
constexpr int kSub = 256;          // SUB: bytes per resolve sub-span
constexpr int kSubsPerChunk = kChunk / kSub;
constexpr int kTokensPad = 384;    // TOKENS_PAD: slots per sub-span
constexpr int kDistMask = 0xFFF;   // TOK_DIST_MASK
constexpr int kMatchBit = 1 << 21; // TOK_MATCH_BIT
constexpr int kFlag = 1 << 30;     // resolved-byte flag

// ---------------------------------------------------------------- windows
// out[l, w] = words[start_w[l] + w] for w < width, 0 past the end of the
// stream.  Both decode kernels do this themselves, into shared memory
// (stage_windows in lane_decode.cuh); this kernel is the way to look at the
// windows they see.

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
// One thread per lane, 32 lanes per block, the walk in one warp.
//
// A lane is a serial chain: a token's position follows from the token
// before it, and a warp that runs alone issues its instructions in order,
// one in four to six cycles.  The kernel's time is therefore not the bytes
// it moves but the longest lane's number of steps times what one step costs
// its warp, and the design cuts both:
//
//  * a step takes two tokens when both are literals: the litlen entry
//    behind the first token is looked up beside the distance entry, at the
//    same index, and its bits are added to the step when both entries say
//    "literal".  The lanes with the most tokens are the ones made of
//    literals, so the longest lane's steps fall to about half its tokens;
//  * a step has no branch but its loop's and one that leaves it for the
//    rare cases (the lane's last token, an invalid code, a distance that
//    can pass 4095, a step of 32 bits or more), which take one token with
//    every check and set the registers up again.  The distance lookup goes
//    out for every token and a clamped shift drops it for a token that is
//    no length; the window's words move through registers by selects;
//  * the block's 32 windows (12 KB) come into shared memory once, straight
//    from the stream: lane l's window is the 96 words at start_w[l], words
//    outside the stream 0 (stage_windows in lane_decode.cuh; no window array
//    in device memory, no launch before this one).  Neighbouring threads
//    take neighbouring words by asynchronous copies, and neighbouring
//    lanes' windows overlap, so the stream is read about once, from L2.  A
//    window row has an odd pitch of 97 words: lanes that read their own
//    word i fall on different banks;
//  * a lane keeps the 96 stream bits at its bit position in three registers
//    (x0, x1, x2) and, behind them, the window's words (r1..r3, p0 and one
//    read ahead).  The lookup index of the next step is one funnel shift by
//    the bits this step used.  Word indices past the window read its last
//    word, as the plain version's clamp does;
//  * the tables are repacked while they are staged, so that the bits an
//    entry consumes are its low five bits (a funnel shift takes its count
//    modulo 32 and needs no mask) and every other field is one shift away;
//  * the next step's lookup goes out before this step is judged, and
//    values, extra bits, distances and the packing, which nothing later
//    depends on, are computed in its shadow.
//
// Tokens stay (T, L): a warp's stores land on neighbouring addresses.

constexpr int kDecodeLanes = 32;             // lanes per block
constexpr int kDecodeThreads = 128;          // all stage, warp 0 walks
constexpr int kWinPitch = kStreamWords + 1;  // odd: no two lanes on a bank

// word i of a window row; an index past it (or before it) reads word 95
__device__ __forceinline__ uint32_t window_word(const int32_t* w, int i) {
  return (uint32_t)w[min((unsigned)i, (unsigned)(kStreamWords - 1))];
}

// the packed token of entry e at the view x (x's bit 0 is the token's
// first bit), its distance entry de looked up at y = x >> (code + extra)
__device__ __forceinline__ int pack_token(int e, uint32_t x, int de,
                                          uint32_t y) {
  const int base = (e >> kEBaseShift) & 511;
  const int ln = (e >> kELnShift) & 15, eb = (e >> kEEbShift) & 7;
  const int len = base + (int)((x >> ln) & ((1u << eb) - 1u));
  return (e & kELen) ? (len | (token_dist(de, y) << 9) | kMatchBit) : base;
}

__global__ void __launch_bounds__(kDecodeThreads)
decode_turbo_kernel(const int32_t* __restrict__ words, int64_t nwords,
                    const int32_t* __restrict__ start_w,
                    const int32_t* __restrict__ bit0,
                    const int32_t* __restrict__ endb,
                    const int32_t* __restrict__ lt_g,
                    const int32_t* __restrict__ dt_g, int lanes,
                    int max_tokens, int32_t* __restrict__ tokens,
                    int32_t* __restrict__ meta) {
  __shared__ int32_t s_win[kDecodeLanes * kWinPitch];
  __shared__ int32_t s_lt[kTable];
  __shared__ int32_t s_dt[kTable];
  const int tid = threadIdx.x;
  const int first = blockIdx.x * kDecodeLanes;
  const int here = min(kDecodeLanes, lanes - first);  // lanes of this block

  stage_windows(words, nwords, start_w + first, here, kStreamWords, kWinPitch,
                s_win, tid, kDecodeThreads);
  for (int i = tid; i < kTable; i += kDecodeThreads) {
    s_lt[i] = repack_lt(__ldg(lt_g + i));
    s_dt[i] = repack_dt(__ldg(dt_g + i), kDistMask);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (tid >= here) return;

  const int l = first + tid;
  const int32_t* w = s_win + tid * kWinPitch;
  int pos = bit0[l];
  const int end = endb[l];
  bool active = pos < end;
  int err = 0;
  int count = 0;
  if (active && max_tokens > 0) {
    uint32_t x0, x1, x2;      // the 96 stream bits at pos, LSB-first
    uint32_t r1, r2, r3, p0;  // window words: x1 = r1:r2 >> s, x2 = r2:r3 >> s
    int wq;                   // index of the word after p0 (95 at most)
    int s;                    // pos & 31
    int e;                    // the entry of the token at pos
    // the registers of a walk that stands at pos
    auto stand = [&]() {
      const int wi = pos >> 5;
      s = pos & 31;
      const uint32_t r0 = window_word(w, wi);
      r1 = window_word(w, wi + 1);
      r2 = window_word(w, wi + 2);
      r3 = window_word(w, wi + 3);
      p0 = window_word(w, wi + 4);
      wq = (int)min((unsigned)(wi + 5), (unsigned)(kStreamWords - 1));
      x0 = __funnelshift_r(r0, r1, s);
      x1 = __funnelshift_r(r1, r2, s);
      x2 = __funnelshift_r(r2, r3, s);
      e = s_lt[x0 & (kTable - 1)];
    };
    stand();
    int32_t* slot = tokens + l;
    for (;;) {
      const int k1 = e & kEUsedMask;
      // the bits behind the first token
      const uint32_t y0 = __funnelshift_r(x0, x1, e);
      const uint32_t y1 = __funnelshift_r(x1, x2, e);
      // both lookups there go out for every token, with no branch: the
      // distance entry counts behind a length (a clamped shift by 32 leaves
      // 0), the litlen entry behind a literal when it is a literal too and a
      // second slot is free
      const int de = s_dt[y0 & (kTable - 1)];
      const int e2 = s_lt[y0 & (kTable - 1)];
      const int dshift = (e & kELen) ? kDUsedShift : 32;
      const int lit_mask =
          ((uint32_t)e >> kELitShift) != 0 && count + 2 <= max_tokens
              ? kEUsedMask : 0;
      const int k2 = (int)((uint32_t)e2 >> kELitShift) & lit_mask;
      const int more = (int)__funnelshift_rc((uint32_t)de, 0u, dshift) | k2;
      const uint32_t nx0 = __funnelshift_r(y0, y1, more);
      // the next step's lookup goes out before this step is judged
      const int e_next = s_lt[nx0 & (kTable - 1)];
      const int used = k1 + more;
      const int tok = pack_token(e, x0, de, y0);
      if ((e & (kEEob | kEBad)) ||
          (uint32_t)(used - 1) >= (uint32_t)min(end - pos - 1, 31)) {
        // rare: the lane's last token, an invalid one, a distance that may
        // pass 4095, or 32 bits or more.  One token, every check.
        const bool is_len = (e & kELen) != 0;
        const int one = k1 + (is_len ? ((de >> kDUsedShift) & 31) : 0);
        if ((e & kEBad) || pos + one > end ||
            (is_len && ((de & 15) == 0 || token_dist(de, y0) > kDistMask))) {
          err = 1;
          active = false;
          break;
        }
        pos += one;
        if (e & kEEob) {
          active = false;
          break;
        }
        *slot = tok;
        slot += lanes;
        ++count;
        active = pos < end;
        if (!active || count >= max_tokens) break;
        stand();
        continue;
      }
      *slot = tok;
      if (k2) slot[lanes] = (e2 >> kEBaseShift) & 511;
      slot += k2 ? 2 * lanes : lanes;
      count += k2 ? 2 : 1;
      pos += used;
      if (count >= max_tokens) break;
      // the word registers move on, by selects, when pos enters a new word
      s += used;
      const uint32_t ahead = (uint32_t)w[wq];
      const int wnext = min(wq + 1, kStreamWords - 1);
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
  meta[l] = count;
  meta[(int64_t)lanes + l] = pos;
  meta[2 * (int64_t)lanes + l] = err;
  meta[3 * (int64_t)lanes + l] = active ? 1 : 0;
}

// ---------------------------------------------------------------- resolve
// One block of 256 threads per 4 KiB chunk row; thread t owns byte t of
// each of the row's 16 sub-spans (q = 256 m + t).
//
// What bounds it: not the bytes (the card moves them in a third of the
// kernel's time) but shared-memory work, the nine dependent lookups of every
// byte's search and the random reads of the jump rounds, in wavefronts and
// in the latency that 32 warps an SM can hide.  The design keeps every
// access of a warp on neighbouring words:
//
//  * The row's 16 sub-spans of starts (16 x 1,536 B, each contiguous and
//    16-byte aligned in the (16, C, 384) layout) come into shared memory by
//    16-byte asynchronous copies, in four groups of four sub-spans: the
//    search of a group's bytes starts when that group has landed, while the
//    later ones are still in flight.
//  * Every byte finds its covering slot there by the plain version's
//    branch-free bisection (nine steps, signed compares), so unsorted starts
//    give the same slot.  A warp's lanes are 32 neighbouring bytes of one
//    sub-span: their probes fall on the same or neighbouring words; a
//    thread's four searches of a group run side by side.  The token is
//    then one read from global memory (only the slots in use are
//    touched, a quarter of toks on real data); all 16 of a thread are in
//    flight before the first is used.
//  * The row's 4,096 states live in shared memory.  A literal is final
//    (kFlag); a match points at its source byte, clip(q - dist, 0, 4095),
//    which lies before it.  The one exception is a byte that copies itself
//    (dist 0, or byte 0 as a match): 12 rounds of doubling leave it as its
//    own index, so its value is q & 255, and it is closed as that final
//    byte when the state is built.  No other cycle can exist, because every
//    other pointer leads backwards.
//  * Pointers are jumped without a barrier between rounds: an entry is at
//    any time final or a pointer to an earlier byte of the same value, and
//    a 32-bit shared-memory write is atomic, so a racing read is as good as
//    an ordered one.  Each pointer strictly decreases a round, so a warp
//    leaves the loop, when none of its entries is a pointer any more, after
//    as many rounds as its chains need (the plain version's fixed 12 reach
//    the same fixpoint).  Neighbouring lanes hold neighbouring bytes, so
//    the bytes of one match read neighbouring sources: no bank conflict
//    inside a copy.
//  * The row leaves as one 16-byte store a thread, packed from four 16-byte
//    reads of the final states.

constexpr int kResolveThreads = kSub;                // a thread a byte of a
                                                     // sub-span, in each of 16
constexpr int kGroups = 4;                           // copy groups
constexpr int kSubsPerGroup = kSubsPerChunk / kGroups;
constexpr int kInt4PerSub = kTokensPad / 4;          // 96

template <int kGroup>
__device__ __forceinline__ void wait_for_group() {
  cp_async_wait<kGroups - 1 - kGroup>();
}

__global__ void __launch_bounds__(kResolveThreads, 4)
resolve_turbo_kernel(const int32_t* __restrict__ toks,
                     const int32_t* __restrict__ starts, int rows,
                     uint8_t* __restrict__ out) {
  __shared__ int4 s_starts4[kSubsPerChunk * kInt4PerSub];
  __shared__ int4 s_state4[kChunk / 4];
  const int32_t* s_starts = reinterpret_cast<const int32_t*>(s_starts4);
  const int c = blockIdx.x;
  const int tid = threadIdx.x;

#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    for (int i = tid; i < kSubsPerGroup * kInt4PerSub; i += kResolveThreads) {
      const int m = g * kSubsPerGroup + i / kInt4PerSub;
      const int j = i % kInt4PerSub;
      cp_async16(&s_starts4[m * kInt4PerSub + j],
                 reinterpret_cast<const int4*>(
                     starts + ((int64_t)m * rows + c) * kTokensPad) + j);
    }
    cp_async_commit();
  }

  // byte m of this thread: byte tid of sub-span m, q = m * 256 + tid
  int tok[kSubsPerChunk];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    if (g == 0) wait_for_group<0>();
    if (g == 1) wait_for_group<1>();
    if (g == 2) wait_for_group<2>();
    if (g == 3) wait_for_group<3>();
    __syncthreads();
    // largest slot with start <= tid (slot 0 when none), the group's four
    // searches side by side.  The first probe is slot 256; the second, 128
    // above, is skipped where it would leave the sub-span's slots
    const int32_t* sp = s_starts + g * kSubsPerGroup * kTokensPad;
    int lo[kSubsPerGroup];
#pragma unroll
    for (int j = 0; j < kSubsPerGroup; ++j) {
      lo[j] = sp[j * kTokensPad + 256] <= tid ? 256 : 0;
      if (lo[j] == 0 && sp[j * kTokensPad + 128] <= tid) lo[j] = 128;
    }
#pragma unroll
    for (int step = 64; step; step >>= 1) {
#pragma unroll
      for (int j = 0; j < kSubsPerGroup; ++j)
        if (sp[j * kTokensPad + lo[j] + step] <= tid) lo[j] += step;
    }
#pragma unroll
    for (int j = 0; j < kSubsPerGroup; ++j) {
      const int m = g * kSubsPerGroup + j;
      tok[m] = __ldg(toks + ((int64_t)m * rows + c) * kTokensPad + lo[j]);
    }
  }

  volatile int32_t* state = reinterpret_cast<int32_t*>(s_state4);
  int v[kSubsPerChunk];
  bool pending = false;
#pragma unroll
  for (int m = 0; m < kSubsPerChunk; ++m) {
    const int t = tok[m];
    const int q = m * kSub + tid;
    const int src = max(q - ((t >> 9) & kDistMask), 0);
    // a literal, or a byte that copies itself, is final
    v[m] = !(t & kMatchBit) ? ((t & 255) | kFlag)
           : src == q       ? ((q & 255) | kFlag)
                            : src;
    state[q] = v[m];
    pending |= !(v[m] & kFlag);
  }
  __syncthreads();
  while (__any_sync(0xFFFFFFFFu, pending)) {
    // the loads first, all in flight together (a final entry reads nothing)
    int y[kSubsPerChunk];
#pragma unroll
    for (int m = 0; m < kSubsPerChunk; ++m) {
      y[m] = v[m];
      if (!(v[m] & kFlag)) y[m] = state[v[m]];
    }
    pending = false;
#pragma unroll
    for (int m = 0; m < kSubsPerChunk; ++m) {
      if (v[m] & kFlag) continue;
      v[m] = y[m];
      state[m * kSub + tid] = y[m];
      pending |= !(y[m] & kFlag);
    }
  }
  __syncthreads();
  // the row leaves as one 16-byte store a thread: bytes 16 * tid ...
  uint32_t word[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int4 f = s_state4[4 * tid + i];
    word[i] = (uint32_t)(f.x & 255) | ((uint32_t)(f.y & 255) << 8) |
              ((uint32_t)(f.z & 255) << 16) | ((uint32_t)(f.w & 255) << 24);
  }
  reinterpret_cast<uint4*>(out + (int64_t)c * kChunk)[tid] =
      make_uint4(word[0], word[1], word[2], word[3]);
}

static_assert(kChunk == 16 * kResolveThreads, "one 16-byte store a thread");
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

int zt_decode_turbo(const void* words, int64_t nwords, const void* start_w,
                    const void* bit0, const void* endb, const void* lt,
                    const void* dt, int lanes, int max_tokens, void* tokens,
                    void* meta, void* stream) {
  unsigned blocks = (unsigned)((lanes + kDecodeLanes - 1) / kDecodeLanes);
  decode_turbo_kernel<<<blocks, kDecodeThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, nwords, (const int32_t*)start_w,
      (const int32_t*)bit0, (const int32_t*)endb, (const int32_t*)lt,
      (const int32_t*)dt, lanes, max_tokens, (int32_t*)tokens,
      (int32_t*)meta);
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
