// Cost probes for a serial per-lane walk on Hopper (sm_90a): the numbers a
// design of decode_turbo / decode_wide (zlibes_tpu_torch/csrc) starts from.
// Each probe is one kernel that reads the SM's cycle counter around a loop
// and writes cycles per operation; tools/probe_hopper.py builds this file
// with nvcc, launches the probes and prints the table.
//
//   smem_chain  a chain of dependent shared-memory lookups (a table walk);
//   global_chain  the same chain through a table in global memory, read by
//               __ldg through L1 (as decode_tokens reads its flattened
//               roots) or by ld.global.cg from L2 (as a resolve_global
//               round follows a pointer that another SM may have written);
//   alu         dependent and independent integer instructions of one warp,
//               alone on its scheduler or beside 1, 3 or 7 busy warps;
//   refill      the funnel-shift / select step that moves a lane's 96-bit
//               stream view on by a data-dependent number of bits;
//   gather      32 scattered lane windows: staged into shared memory by
//               cp.async and then read in a dependent chain, against the
//               same chain read straight from global memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTable = 2048;

__global__ void smem_chain_kernel(int iters, long long* cycles, int* sink) {
  __shared__ int table[kTable];
  for (int i = threadIdx.x; i < kTable; i += blockDim.x)
    table[i] = (i * 5 + 1 + 64 * (i & 31)) & (kTable - 1);
  __syncthreads();
  int idx = threadIdx.x;
  const long long t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < iters; ++i) idx = table[idx];
  const long long t1 = clock64();
  if (threadIdx.x == 0) *cycles = t1 - t0;
  sink[threadIdx.x] = idx;
}

// table: kTable entries in global memory, as smem_chain_kernel fills its
// own; a first pass over it brings it into the cache the chain reads
template <bool kL1>
__global__ void global_chain_kernel(const int* __restrict__ table,
                                    int iters, long long* cycles, int* sink) {
  int warm = 0;
  for (int i = threadIdx.x; i < kTable; i += blockDim.x)
    warm ^= kL1 ? __ldg(table + i) : __ldcg(table + i);
  int idx = threadIdx.x;
  const long long t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < iters; ++i)
    idx = kL1 ? __ldg(table + idx) : __ldcg(table + idx);
  const long long t1 = clock64();
  if (threadIdx.x == 0) *cycles = t1 - t0;
  sink[threadIdx.x] = idx ^ warm;
}

// warp 0 is timed; every warp runs the same loop.  chains = 1: each
// instruction depends on the one before it; chains = 4: four independent
// chains interleaved.
template <int kChains>
__global__ void alu_kernel(int iters, long long* cycles, int* sink) {
  int x[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) x[c] = threadIdx.x + c;
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 4
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) x[c] = (x[c] ^ (x[c] >> 3)) + i;
  }
  const long long t1 = clock64();
  int acc = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c) acc += x[c];
  if (threadIdx.x == 0) *cycles = t1 - t0;
  sink[threadIdx.x] = acc;
}

__global__ void refill_kernel(int iters, int width, long long* cycles,
                              int* sink) {
  extern __shared__ int32_t win[];  // 32 rows of width + 1 words
  const int pitch = width + 1;
  for (int i = threadIdx.x; i < 32 * pitch; i += blockDim.x)
    win[i] = i * 0x9E3779B1u;
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int32_t* w = win + threadIdx.x * pitch;
  uint32_t r1 = w[1], r2 = w[2], r3 = w[3], p0 = w[4];
  int wq = 5, s = threadIdx.x & 31;
  uint32_t x0 = __funnelshift_r((uint32_t)w[0], r1, s);
  uint32_t x1 = __funnelshift_r(r1, r2, s);
  uint32_t x2 = __funnelshift_r(r2, r3, s);
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    const int used = (x0 & 15) | 1;  // data-dependent, 1..15 bits
    const uint32_t nx0 = __funnelshift_r(x0, x1, used);
    s += used;
    const uint32_t ahead = (uint32_t)w[wq];
    const int wnext = wq + 1 < width ? wq + 1 : 0;
    if (s >= 32) {
      r1 = r2; r2 = r3; r3 = p0; p0 = ahead;
      wq = wnext;
      s -= 32;
    }
    x0 = nx0 ^ (x2 >> 31);
    x1 = __funnelshift_r(r1, r2, s);
    x2 = __funnelshift_r(r2, r3, s);
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) *cycles = t1 - t0;
  sink[threadIdx.x] = x0 + x1 + x2;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(smem)),
               "l"(gmem)
               : "memory");
}

// cycles[0]: staging the block's 32 windows (0 when direct); cycles[1]: a
// chain of `reads` dependent reads per lane, each lane inside its own window
template <bool kStaged>
__global__ void gather_kernel(const int32_t* __restrict__ words,
                              const int32_t* __restrict__ start_w, int width,
                              int reads, long long* cycles, int* sink) {
  extern __shared__ int32_t win[];
  const int pitch = width + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int32_t* start = start_w + blockIdx.x * 32;
  const long long t0 = clock64();
  if (kStaged) {
    for (int r = warp; r < 32; r += blockDim.x >> 5) {
      const int first = start[r];
      for (int w = lane; w < width; w += 32)
        cp_async4(win + r * pitch + w, words + first + w);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x >= 32) return;
  const int32_t* w = kStaged ? win + lane * pitch : words + start[lane];
  int idx = 0, acc = 0;
  for (int i = 0; i < reads; ++i) {
    const int v = w[idx];
    acc += v;
    idx += 1 + (v & 1);  // the next read depends on this one
    if (idx >= width) idx -= width;
  }
  const long long t2 = clock64();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    cycles[0] = t1 - t0;
    cycles[1] = t2 - t1;
  }
  sink[blockIdx.x * 32 + lane] = acc;
}

}  // namespace

extern "C" {

int probe_smem_chain(int iters, void* cycles, void* sink) {
  smem_chain_kernel<<<1, 32>>>(iters, (long long*)cycles, (int*)sink);
  return (int)cudaDeviceSynchronize();
}

int probe_global_chain(int l1, const void* table, int iters, void* cycles,
                       void* sink) {
  if (l1)
    global_chain_kernel<true><<<1, 32>>>((const int*)table, iters,
                                         (long long*)cycles, (int*)sink);
  else
    global_chain_kernel<false><<<1, 32>>>((const int*)table, iters,
                                          (long long*)cycles, (int*)sink);
  return (int)cudaDeviceSynchronize();
}

// warps: warps of the one block (4 schedulers an SM: 4 warps = one each)
int probe_alu(int warps, int chains, int iters, void* cycles, void* sink) {
  if (chains == 1)
    alu_kernel<1><<<1, 32 * warps>>>(iters, (long long*)cycles, (int*)sink);
  else
    alu_kernel<4><<<1, 32 * warps>>>(iters, (long long*)cycles, (int*)sink);
  return (int)cudaDeviceSynchronize();
}

int probe_refill(int iters, int width, void* cycles, void* sink) {
  refill_kernel<<<1, 128, 32 * (width + 1) * sizeof(int32_t)>>>(
      iters, width, (long long*)cycles, (int*)sink);
  return (int)cudaDeviceSynchronize();
}

int probe_gather(int staged, const void* words, const void* start_w,
                 int blocks, int width, int reads, void* cycles, void* sink) {
  const size_t smem = 32 * (width + 1) * sizeof(int32_t);
  if (staged)
    gather_kernel<true><<<blocks, 128, smem>>>(
        (const int32_t*)words, (const int32_t*)start_w, width, reads,
        (long long*)cycles, (int*)sink);
  else
    gather_kernel<false><<<blocks, 128, smem>>>(
        (const int32_t*)words, (const int32_t*)start_w, width, reads,
        (long long*)cycles, (int*)sink);
  return (int)cudaDeviceSynchronize();
}

}  // extern "C"
