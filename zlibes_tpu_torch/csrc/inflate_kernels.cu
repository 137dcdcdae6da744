// Generic indexed inflate kernels for Hopper (sm_90a): decode_tokens and
// resolve_global.
//
// One kernel per stage of zlibes_tpu_torch/ops/inflate_kernel.py (the
// resolve takes a few launches), each with a plain extern "C" launcher that
// takes device pointers and a CUDA stream, launches on that stream, and
// returns cudaGetLastError().  The Python wrappers check shapes, types and
// devices and allocate every output and scratch array; the plain PyTorch
// versions beside them define the same results.
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
// One thread a lane, one warp a block.  A generic lane is about 4 KiB of
// output and up to ~1,900 stream words, too wide to stage, so a lane reads
// the stream through a 64-bit bit buffer in registers: a refill ORs in the
// next word, which was loaded at the refill before.  A token takes at most
// 20 bits of code and extra for its litlen symbol and 28 for its distance;
// the buffer holds more than 32 after a refill, so one refill goes before
// each half.  The distance is looked up behind every token, a literal's
// dropped: a warp's lanes mostly disagree on a branch there.  Positions
// are 32-bit, from the lane's first bit.  The tables are the lane's block
// row of two-level tables (7 KB), read through L1: neighbouring lanes
// mostly share a row.
//
// The kernel's time is its longest lane's chain of tokens on a warp that
// runs alone, ~950 cycles a token on the flushed bench stream
// (chip_smoke.py).  Memory is not what binds it: of the variants that
// tools/probe_decode_tokens.py times (tables staged in shared memory, the
// distance lookup behind a branch, no word loaded ahead, lanes a block)
// none is more than ~1% faster; what a token costs is the instructions of
// one step, as in the first designs of decode_turbo and decode_wide.
// Their redesign (repacked one-level roots, a 96-bit view in 32-bit
// registers, two literals a step) is the way on.

constexpr int kDecodeThreads = 32;   // lanes a block

__global__ void __launch_bounds__(kDecodeThreads)
decode_tokens_kernel(const uint32_t* __restrict__ words, int64_t nwords,
                     const int32_t* __restrict__ lt,
                     const int32_t* __restrict__ dt, int nrows,
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
  const int l = blockIdx.x * kDecodeThreads + threadIdx.x;
  if (l >= lanes) return;
  const int64_t row = min(max(table_row[l], 0), nrows - 1);
  const int32_t* lt_r = lt + row * kLlW;
  const int32_t* dt_r = dt + row * kDW;
  const int64_t start = bit0[l];
  // the lane's end bit from its start, clipped to [-1, 2^31 - 64): a lane
  // whose end lies before its start errs at its first token, as it would
  // unclipped; one of 2^31 bits or more errs at the clip
  const int span =
      (int)max(min(end_bit[l] - start, (int64_t)INT32_MAX - 64), (int64_t)-1);
  int pos = 0;
  bool active = active0[l];
  bool err = false;
  int count = 0;
  if (active && max_tokens > 0) {
    auto word = [&](int64_t i) -> uint64_t {
      return (uint64_t)i < (uint64_t)nwords ? (uint64_t)__ldg(words + i)
                                            : 0ull;
    };
    // the bits from pos on: buf holds avail of them; nxt is word nw
    int64_t nw = start >> 5;
    uint64_t buf = word(nw) >> (start & 31);
    int avail = 32 - (int)(start & 31);
    ++nw;
    uint64_t nxt = word(nw);
    auto refill = [&]() {
      while (avail <= 32) {
        buf |= nxt << avail;
        avail += 32;
        nxt = word(++nw);
      }
    };
    int slot = l;  // of the next token, in tokens and in starts
    int outpos = 0;
    for (;;) {
      refill();
      const uint32_t x = (uint32_t)buf;
      const int e = lookup_ll<true>(lt_r, x);
      const int ln = e & 15, kind = (e >> 4) & 3, eb = (e >> 6) & 7;
      const bool is_len = kind == kKindLen;
      int val = (e >> 9) & 511;
      if (is_len) val += (int)((x >> ln) & ((1u << eb) - 1u));
      const int k1 = ln + eb;
      buf >>= k1;
      avail -= k1;
      // the distance behind every token, kept for a length
      refill();
      const uint32_t y = (uint32_t)buf;
      const int de = lookup_d<true>(dt_r, y);
      const int dln = de & 15, deb = (de >> 4) & 15;
      const int dist = token_dist(de, y);
      const int dk = is_len ? dln + deb : 0;
      buf >>= dk;
      avail -= dk;
      const bool bad =
          ln == 0 || kind == kKindInvalid || (is_len && dln == 0);
      const int newpos = pos + k1 + dk;
      if (bad || newpos > span) {
        err = true;
        active = false;
        break;
      }
      pos = newpos;
      if (kind == kKindEob) {
        active = false;
        break;
      }
      tokens[slot] = is_len ? (val | (dist << 9) | kMatchBit) : val;
      starts[slot] = outpos;
      slot += lanes;
      outpos += is_len ? val : 1;
      ++count;
      active = pos < span;
      if (!active || count >= max_tokens) break;
    }
  }
  count_out[l] = count;
  bitpos_out[l] = start + pos;
  active_out[l] = active;
  err_out[l] = err;
}

// ---------------------------------------------------------------- resolve
// Three kernels, launched back to back by zt_resolve_global.
//
// init: every byte's state is final 0 (kFinal), or its prefix byte below P.
// expand: one thread a token slot (lanes side by side, so a warp reads
// neighbouring tokens); a valid token writes its bytes in [max(start, P),
// total): a literal final, a copy byte its source q - dist, or for an
// overlapping copy (dist < length) start - dist + (q - start) % dist,
// final at once when the source lies in the prefix.  A source below 0
// sets err and reads byte 0.
// jump, once a round: a byte whose state is a source takes the source's
// state, in place (a racing read sees the old or a newer state, both on
// the same chain, so the order of the threads does not matter).  Every
// source lies before its byte, a round at least halves every chain, and
// ceil(log2(total)) rounds finish any chain the span can hold; a round that
// finds none open (its flag stays 0) makes the later rounds return at once.
// The last round writes the bytes.

constexpr int kFinal = (int)0x80000000u;  // state: final byte in bits 0-7
constexpr int kResolveThreads = 256;

__global__ void __launch_bounds__(kResolveThreads)
resolve_global_init_kernel(const uint8_t* __restrict__ prefix, int P,
                           int total, int32_t* __restrict__ state) {
  for (int q = blockIdx.x * kResolveThreads + threadIdx.x; q < total;
       q += gridDim.x * kResolveThreads)
    state[q] = kFinal | (q < P ? (int)prefix[q] : 0);
}

__global__ void __launch_bounds__(kResolveThreads)
resolve_global_expand_kernel(const int32_t* __restrict__ tokens,
                             const int32_t* __restrict__ starts,
                             const int32_t* __restrict__ count,
                             const int32_t* __restrict__ out_base,
                             int64_t slots, int lanes,
                             const uint8_t* __restrict__ prefix, int P,
                             int total, int32_t* __restrict__ state,
                             int32_t* __restrict__ err) {
  const int64_t i = (int64_t)blockIdx.x * kResolveThreads + threadIdx.x;
  if (i >= slots) return;
  const int b = (int)(i % lanes);
  const int t = (int)(i / lanes);
  if (t >= count[b]) return;
  const int tok = tokens[i];
  const int64_t g = (int64_t)out_base[b] + starts[i];
  const bool is_match = (tok & kMatchBit) != 0;
  const int len = is_match ? (tok & 511) : 1;
  const int64_t lo = g > P ? g : P;
  const int64_t hi = g + len < total ? g + len : total;
  if (!is_match) {
    if (lo < hi) state[lo] = kFinal | (tok & 255);
    return;
  }
  const int dist = (tok >> 9) & 0xFFFF;
  if (dist == 0) return;  // not a valid match: no decoder writes one
  bool below = false;
  for (int64_t q = lo; q < hi; ++q) {
    const int64_t off = q - g;
    int64_t src = g - dist + (off < dist ? off : off % dist);
    if (src < 0) {
      below = true;
      src = 0;
    }
    state[q] = src < P ? (kFinal | (int)prefix[src]) : (int32_t)src;
  }
  if (below) *err = 1;
}

__global__ void __launch_bounds__(kResolveThreads)
resolve_global_jump_kernel(int32_t* state, int total,
                           int32_t* __restrict__ open, int round, bool last,
                           uint8_t* __restrict__ out) {
  if (round > 0 && !open[round - 1]) {
    // nothing was open after the round before: only the bytes to write
    if (last)
      for (int q = blockIdx.x * kResolveThreads + threadIdx.x; q < total;
           q += gridDim.x * kResolveThreads)
        out[q] = (uint8_t)state[q];
    return;
  }
  bool still = false;
  for (int q = blockIdx.x * kResolveThreads + threadIdx.x; q < total;
       q += gridDim.x * kResolveThreads) {
    int s = state[q];
    if (s >= 0) {
      s = ((volatile int32_t*)state)[s];
      state[q] = s;
      still |= s >= 0;
    }
    if (last) out[q] = (uint8_t)s;
  }
  if (__any_sync(0xFFFFFFFFu, still) && (threadIdx.x & 31) == 0)
    open[round] = 1;
}

}  // namespace

extern "C" {

// nrows: rows of lt and dt (a lane's row is clamped into them)
int zt_decode_tokens(const void* words, int64_t nwords, const void* lt,
                     const void* dt, int nrows, const void* table_row,
                     const void* bit0, const void* end_bit,
                     const void* active0, int lanes, int max_tokens,
                     void* tokens, void* starts, void* count, void* bitpos,
                     void* active, void* err, void* stream) {
  const unsigned blocks =
      (unsigned)((lanes + kDecodeThreads - 1) / kDecodeThreads);
  decode_tokens_kernel<<<blocks, kDecodeThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, nwords, (const int32_t*)lt, (const int32_t*)dt,
      nrows, (const int32_t*)table_row, (const int64_t*)bit0,
      (const int64_t*)end_bit, (const bool*)active0, lanes, max_tokens,
      (int32_t*)tokens, (int32_t*)starts, (int32_t*)count, (int64_t*)bitpos,
      (bool*)active, (bool*)err);
  return (int)cudaGetLastError();
}

// state: scratch of total int32; open: rounds + 1 int32; err: one int32,
// zeroed by the wrapper
int zt_resolve_global(const void* tokens, const void* starts,
                      const void* count, const void* out_base, int T,
                      int lanes, const void* prefix, int P, int total,
                      int rounds, void* state, void* open, void* out,
                      void* err, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // grid-stride passes over the bytes: a few blocks an SM
  const int64_t want =
      ((int64_t)total + kResolveThreads - 1) / kResolveThreads;
  const unsigned byte_blocks =
      (unsigned)(want < (int64_t)sms * 8 ? want : (int64_t)sms * 8);
  cudaError_t e = cudaMemsetAsync(open, 0, (size_t)(rounds + 1) * 4, s);
  if (e != cudaSuccess) return (int)e;
  resolve_global_init_kernel<<<byte_blocks, kResolveThreads, 0, s>>>(
      (const uint8_t*)prefix, P, total, (int32_t*)state);
  const int64_t slots = (int64_t)T * lanes;
  if (slots > 0)
    resolve_global_expand_kernel<<<(unsigned)((slots + kResolveThreads - 1) /
                                              kResolveThreads),
                                   kResolveThreads, 0, s>>>(
        (const int32_t*)tokens, (const int32_t*)starts, (const int32_t*)count,
        (const int32_t*)out_base, slots, lanes, (const uint8_t*)prefix, P,
        total, (int32_t*)state, (int32_t*)err);
  for (int r = 0; r < rounds; ++r)
    resolve_global_jump_kernel<<<byte_blocks, kResolveThreads, 0, s>>>(
        (int32_t*)state, total, (int32_t*)open, r, r == rounds - 1,
        (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
