// Variants of the select_tokens kernel, for tools/probe_select_tokens.py.
//
// Includes the port's encode_kernels.cu as it stands (its select_step,
// token pass, store_marked and the committed zt_select_tokens come along)
// and adds other ways of marking a lane's token chain, each behind a
// launcher with zt_select_tokens' signature (split_far off: the variants
// are of the general encoder's instance, and take no other value):
//
//   zp_select_tokens_walk     the first design: thread 0 follows the chain
//                             from position 0, one dependent shared-memory
//                             load a token, writing token t at slot t;
//   zp_select_tokens_doubling pointer doubling over the successors: mark 0,
//                             then each round every marked c marks J[c]
//                             (atomicOr on mark words) and J <- J o J, until
//                             J[J[0]] is the end: ceil(log2 count) rounds;
//   zp_select_tokens_dbytes   the same with a byte a mark (plain stores);
//   zp_select_tokens_spec     a warp's speculative walk of 32 pieces, then
//                             one thread following the true chain piece by
//                             piece until it meets a position the
//                             speculative walk visited;
//   zp_select_tokens_jacobi   the same fix-up done by all 32 lanes at once,
//                             each from its assumed entry, again until no
//                             entry changes, with no memory of earlier walks
//                             (the committed kernel adds that memory);
//   zp_select_tokens_floor, _pass
//                             parts, not exact: the token pass and the store
//                             of a one-token chain; the pass alone.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC -shared -I zlibes_tpu_torch/csrc
//        -o libprobe_select_tokens.so tools/probe_select_tokens.cu

#include "encode_kernels.cu"

namespace {

__global__ void __launch_bounds__(kTokThreads)
select_tokens_walk_kernel(const uint8_t* __restrict__ data, int64_t pitch,
                          const int32_t* __restrict__ matches,
                          const int32_t* __restrict__ n_valid, int N,
                          int nseg, int seg, int start, int lazy,
                          int32_t* __restrict__ tv, int32_t* __restrict__ td,
                          int32_t* __restrict__ counts) {
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
    const int w = c < cnt ? tok_row[c].x : 0;
    tv_row[c] = w & 0x1FF;
    td_row[c] = (w >> kDistShift) & 0xFFFF;
  }
}

// tokens (4 B) and J twice (2 B each) a position, then the mark words
int doubling_smem(int seg) { return 8 * seg + 4 * ((seg + 31) / 32); }

__global__ void __launch_bounds__(kTokThreads)
select_tokens_doubling_kernel(const uint8_t* __restrict__ data, int64_t pitch,
                              const int32_t* __restrict__ matches,
                              const int32_t* __restrict__ n_valid, int N,
                              int nseg, int seg, int start, int lazy,
                              int32_t* __restrict__ tv,
                              int32_t* __restrict__ td,
                              int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char dbl_smem[];
  int32_t* tok = reinterpret_cast<int32_t*>(dbl_smem);
  uint16_t* J = reinterpret_cast<uint16_t*>(dbl_smem + 4 * seg);
  uint16_t* Jn = J + seg;
  uint32_t* mark = reinterpret_cast<uint32_t*>(dbl_smem + 8 * seg);
  const int tid = threadIdx.x;
  const int lane = blockIdx.x;
  const int b = lane / nseg;
  const int seg0 = start + (lane % nseg) * seg;
  const int seg_len = min(max(n_valid[b] - seg0, 0), seg);
  const int nwords = (seg_len + 31) >> 5;

  select_tokens_pass<false>(data + (int64_t)b * pitch + seg0,
                            matches + (int64_t)b * N + seg0, seg_len,
                            lazy, 31, tok, J);
  for (int w = tid; w < nwords; w += kTokThreads) mark[w] = w == 0 ? 1u : 0u;
  __syncthreads();
  // marks are only ever set, and only on the chain: a mark seen in the round
  // it was set only marks a later position of the chain
  if (seg_len > 0 && J[0] < seg_len) {
    for (;;) {
      const bool last = J[J[0]] >= seg_len;
      for (int c = tid; c < seg_len; c += kTokThreads) {
        const int jc = J[c];
        if (jc < seg_len) {
          if ((mark[c >> 5] >> (c & 31)) & 1u)
            atomicOr(&mark[jc >> 5], 1u << (jc & 31));
          if (!last) Jn[c] = J[jc];
        } else if (!last) {
          Jn[c] = (uint16_t)seg_len;
        }
      }
      __syncthreads();
      if (last) break;
      uint16_t* t = J;
      J = Jn;
      Jn = t;
    }
  }
  store_marked(mark, tok, seg, seg_len, tv + (int64_t)lane * seg,
               td + (int64_t)lane * seg, counts + lane);
}

// tokens (4 B), successors (2 B), then two mark arrays a position
int spec_smem(int seg) {
  return ((6 * seg + 3) & ~3) + 8 * ((seg + 31) / 32);
}

__global__ void __launch_bounds__(kTokThreads)
select_tokens_spec_kernel(const uint8_t* __restrict__ data, int64_t pitch,
                          const int32_t* __restrict__ matches,
                          const int32_t* __restrict__ n_valid, int N,
                          int nseg, int seg, int start, int lazy,
                          int32_t* __restrict__ tv, int32_t* __restrict__ td,
                          int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char spec_smem_[];
  int32_t* tok = reinterpret_cast<int32_t*>(spec_smem_);
  uint16_t* nxt = reinterpret_cast<uint16_t*>(spec_smem_ + 4 * seg);
  uint32_t* spec =
      reinterpret_cast<uint32_t*>(spec_smem_ + ((6 * seg + 3) & ~3));
  uint32_t* fix = spec + (seg + 31) / 32;
  __shared__ int s_exit[kPieces];
  __shared__ int s_sync[kPieces];
  const int tid = threadIdx.x;
  const int lane = blockIdx.x;
  const int b = lane / nseg;
  const int seg0 = start + (lane % nseg) * seg;
  const int seg_len = min(max(n_valid[b] - seg0, 0), seg);
  const int nwords = (seg_len + 31) >> 5;

  select_tokens_pass<false>(data + (int64_t)b * pitch + seg0,
                            matches + (int64_t)b * N + seg0, seg_len,
                            lazy, 31, tok, nxt);
  for (int w = tid; w < nwords; w += kTokThreads) {
    spec[w] = 0;
    fix[w] = 0;
  }
  __syncthreads();

  // pieces of a multiple of 32 positions: every mark word lies in one piece,
  // written by one thread
  const int P = ((seg_len + kPieces - 1) / kPieces + 31) & ~31;
  if (tid < 32) {
    int c = tid * P;
    const int end = min(c + P, seg_len);
    int word = c >> 5;
    uint32_t bits = 0;
    while (c < end) {
      if ((c >> 5) != word) {
        spec[word] = bits;
        bits = 0;
        word = c >> 5;
      }
      bits |= 1u << (c & 31);
      c = nxt[c];
    }
    if (bits) spec[word] = bits;
    s_exit[tid] = c;
    __syncwarp();
    if (tid == 0) {
      int e = s_exit[0];
      s_sync[0] = 0;
      for (int p = 1; p * P < seg_len; ++p) {
        const int end_p = min((p + 1) * P, seg_len);
        int v = end_p;  // no resync: every speculative mark of p is false
        int fw = e >> 5;
        uint32_t fb = 0;
        while (e < end_p) {
          if ((spec[e >> 5] >> (e & 31)) & 1u) {
            v = e;
            e = s_exit[p];
            break;
          }
          if ((e >> 5) != fw) {
            fix[fw] |= fb;
            fb = 0;
            fw = e >> 5;
          }
          fb |= 1u << (e & 31);
          e = nxt[e];
        }
        if (fb) fix[fw] |= fb;
        s_sync[p] = v;
      }
    }
  }
  __syncthreads();
  // the chain: the true walk's positions before each piece's resync point,
  // the speculative ones from it on
  for (int w = tid; w < nwords; w += kTokThreads) {
    const int lo = 32 * w;
    const int v = s_sync[lo / P];
    const uint32_t keep =
        v <= lo ? ~0u : v >= lo + 32 ? 0u : ~0u << (v - lo);
    spec[w] = fix[w] | (spec[w] & keep);
  }
  __syncthreads();
  store_marked(spec, tok, seg, seg_len, tv + (int64_t)lane * seg,
               td + (int64_t)lane * seg, counts + lane);
}

// spec with the fix-up in parallel: piece p first assumes that it is
// entered where the speculative walk of piece p - 1 left it, each piece
// walks from its assumed entry until it meets a position its speculative
// walk visited; a piece whose assumed entry changed walks again, until no
// entry changes (one round more than the longest run of pieces that do
// not resynchronise).
__global__ void __launch_bounds__(kTokThreads)
select_tokens_jacobi_kernel(const uint8_t* __restrict__ data, int64_t pitch,
                            const int32_t* __restrict__ matches,
                            const int32_t* __restrict__ n_valid, int N,
                            int nseg, int seg, int start, int lazy,
                            int32_t* __restrict__ tv,
                            int32_t* __restrict__ td,
                            int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char spec_smem_[];
  int32_t* tok = reinterpret_cast<int32_t*>(spec_smem_);
  uint16_t* nxt = reinterpret_cast<uint16_t*>(spec_smem_ + 4 * seg);
  uint32_t* spec =
      reinterpret_cast<uint32_t*>(spec_smem_ + ((6 * seg + 3) & ~3));
  uint32_t* fix = spec + (seg + 31) / 32;
  __shared__ int s_sync[kPieces];
  const int tid = threadIdx.x;
  const int lane = blockIdx.x;
  const int b = lane / nseg;
  const int seg0 = start + (lane % nseg) * seg;
  const int seg_len = min(max(n_valid[b] - seg0, 0), seg);
  const int nwords = (seg_len + 31) >> 5;

  select_tokens_pass<false>(data + (int64_t)b * pitch + seg0,
                            matches + (int64_t)b * N + seg0, seg_len,
                            lazy, 31, tok, nxt);
  for (int w = tid; w < nwords; w += kTokThreads) {
    spec[w] = 0;
    fix[w] = 0;
  }
  __syncthreads();

  const int P = ((seg_len + kPieces - 1) / kPieces + 31) & ~31;
  if (tid < 32) {
    const int p = tid;
    const int beg = p * P;
    const int end = min(beg + P, seg_len);
    int c = beg;
    int word = c >> 5;
    uint32_t bits = 0;
    while (c < end) {
      if ((c >> 5) != word) {
        spec[word] = bits;
        bits = 0;
        word = c >> 5;
      }
      bits |= 1u << (c & 31);
      c = nxt[c];
    }
    if (bits) spec[word] = bits;
    const int ex = c;  // the speculative exit
    __syncwarp();
    const bool real = p >= 1 && beg < seg_len;
    int entry = __shfl_up_sync(0xffffffffu, ex, 1);
    int v = 0;
    int out = ex;
    bool todo = real;
    for (;;) {
      if (todo) {
        for (int w = beg >> 5; w < (end + 31) >> 5; ++w) fix[w] = 0;
        int e = entry;
        v = end;
        int fw = e >> 5;
        uint32_t fb = 0;
        while (e < end) {
          if ((spec[e >> 5] >> (e & 31)) & 1u) {
            v = e;
            break;
          }
          if ((e >> 5) != fw) {
            fix[fw] |= fb;
            fb = 0;
            fw = e >> 5;
          }
          fb |= 1u << (e & 31);
          e = nxt[e];
        }
        if (fb) fix[fw] |= fb;
        out = v < end ? ex : e;
      }
      const int nentry = __shfl_up_sync(0xffffffffu, out, 1);
      todo = real && nentry != entry;
      if (!__any_sync(0xffffffffu, todo)) break;
      entry = nentry;
    }
    s_sync[p] = v;
  }
  __syncthreads();
  for (int w = tid; w < nwords; w += kTokThreads) {
    const int lo = 32 * w;
    const int v = s_sync[lo / P];
    const uint32_t keep =
        v <= lo ? ~0u : v >= lo + 32 ? 0u : ~0u << (v - lo);
    spec[w] = fix[w] | (spec[w] & keep);
  }
  __syncthreads();
  store_marked(spec, tok, seg, seg_len, tv + (int64_t)lane * seg,
               td + (int64_t)lane * seg, counts + lane);
}

// doubling with a byte a mark: plain byte stores in place of atomicOr on
// mark words; the words for the rank are one ballot a warp and 32 positions
int dbytes_smem(int seg) { return 9 * seg + 4 * ((seg + 31) / 32) + 4; }

__global__ void __launch_bounds__(kTokThreads)
select_tokens_dbytes_kernel(const uint8_t* __restrict__ data, int64_t pitch,
                            const int32_t* __restrict__ matches,
                            const int32_t* __restrict__ n_valid, int N,
                            int nseg, int seg, int start, int lazy,
                            int32_t* __restrict__ tv,
                            int32_t* __restrict__ td,
                            int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char db_smem[];
  int32_t* tok = reinterpret_cast<int32_t*>(db_smem);
  uint16_t* J = reinterpret_cast<uint16_t*>(db_smem + 4 * seg);
  uint16_t* Jn = J + seg;
  uint32_t* words = reinterpret_cast<uint32_t*>(db_smem + 8 * seg);
  uint8_t* markb =
      reinterpret_cast<uint8_t*>(words + (seg + 31) / 32);
  const int tid = threadIdx.x;
  const int lane = blockIdx.x;
  const int b = lane / nseg;
  const int seg0 = start + (lane % nseg) * seg;
  const int seg_len = min(max(n_valid[b] - seg0, 0), seg);
  const int nwords = (seg_len + 31) >> 5;

  select_tokens_pass<false>(data + (int64_t)b * pitch + seg0,
                            matches + (int64_t)b * N + seg0, seg_len,
                            lazy, 31, tok, J);
  for (int c = tid; c < seg_len; c += kTokThreads) markb[c] = c == 0;
  __syncthreads();
  if (seg_len > 0 && J[0] < seg_len) {
    for (;;) {
      const bool last = J[J[0]] >= seg_len;
      for (int c = tid; c < seg_len; c += kTokThreads) {
        const int jc = J[c];
        if (jc < seg_len) {
          if (markb[c]) markb[jc] = 1;
          if (!last) Jn[c] = J[jc];
        } else if (!last) {
          Jn[c] = (uint16_t)seg_len;
        }
      }
      __syncthreads();
      if (last) break;
      uint16_t* t = J;
      J = Jn;
      Jn = t;
    }
  }
  for (int c = tid; c < 32 * nwords; c += kTokThreads) {
    const unsigned bal = __ballot_sync(0xffffffffu, c < seg_len && markb[c]);
    if ((c & 31) == 0) words[c >> 5] = bal;
  }
  __syncthreads();
  store_marked(words, tok, seg, seg_len, tv + (int64_t)lane * seg,
               td + (int64_t)lane * seg, counts + lane);
}

// not exact, by design: the token pass and the rank and store of a chain of
// one token, to time what every variant pays besides marking its chain
// (``store`` 0: the pass and the count alone)
template <int kStore>
__global__ void __launch_bounds__(kTokThreads)
select_tokens_floor_kernel(const uint8_t* __restrict__ data, int64_t pitch,
                           const int32_t* __restrict__ matches,
                           const int32_t* __restrict__ n_valid, int N,
                           int nseg, int seg, int start, int lazy,
                           int32_t* __restrict__ tv, int32_t* __restrict__ td,
                           int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char tok_smem[];
  int32_t* tok = reinterpret_cast<int32_t*>(tok_smem);
  uint16_t* J = reinterpret_cast<uint16_t*>(tok_smem + 4 * seg);
  uint32_t* mark = reinterpret_cast<uint32_t*>(tok_smem + 8 * seg);
  const int tid = threadIdx.x;
  const int lane = blockIdx.x;
  const int b = lane / nseg;
  const int seg0 = start + (lane % nseg) * seg;
  const int seg_len = min(max(n_valid[b] - seg0, 0), seg);
  const int nwords = (seg_len + 31) >> 5;
  select_tokens_pass<false>(data + (int64_t)b * pitch + seg0,
                            matches + (int64_t)b * N + seg0, seg_len,
                            lazy, 31, tok, J);
  for (int w = tid; w < nwords; w += kTokThreads) mark[w] = w == 0 ? 1u : 0u;
  __syncthreads();
  if (kStore) {
    store_marked(mark, tok, seg, seg_len, tv + (int64_t)lane * seg,
                 td + (int64_t)lane * seg, counts + lane);
  } else if (tid == 0) {
    counts[lane] = tok[0] + J[seg_len > 0 ? seg_len - 1 : 0];
  }
}

template <typename Kernel>
int launch_variant(Kernel kernel, int smem, const void* data, int64_t pitch,
                   const void* matches, const void* n_valid, int N, int nseg,
                   int seg, int start, int lazy, int split_far, int lanes,
                   void* tv, void* td, void* counts, void* stream) {
  if (seg <= 0 || seg > kMaxTokSeg || split_far)
    return (int)cudaErrorInvalidValue;
  if (smem > 40 * 1024) {
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

}  // namespace

extern "C" {

// every launcher takes zt_select_tokens' arguments
#define ZP_ARGS                                                          \
  const void *data, int64_t pitch, const void *matches,                  \
      const void *n_valid, int N, int nseg, int seg, int start, int lazy, \
      int split_far, int lanes, void *tv, void *td, void *counts,        \
      void *stream
#define ZP_PASS                                                          \
  data, pitch, matches, n_valid, N, nseg, seg, start, lazy, split_far,   \
      lanes, tv, td, counts, stream

int zp_select_tokens_walk(ZP_ARGS) {
  return launch_variant(select_tokens_walk_kernel, 8 * seg, ZP_PASS);
}

int zp_select_tokens_jacobi(ZP_ARGS) {
  return launch_variant(select_tokens_jacobi_kernel, spec_smem(seg), ZP_PASS);
}

int zp_select_tokens_dbytes(ZP_ARGS) {
  return launch_variant(select_tokens_dbytes_kernel, dbytes_smem(seg), ZP_PASS);
}

int zp_select_tokens_floor(ZP_ARGS) {
  return launch_variant(select_tokens_floor_kernel<1>, doubling_smem(seg),
                        ZP_PASS);
}

int zp_select_tokens_pass(ZP_ARGS) {
  return launch_variant(select_tokens_floor_kernel<0>, doubling_smem(seg),
                        ZP_PASS);
}

int zp_select_tokens_doubling(ZP_ARGS) {
  return launch_variant(select_tokens_doubling_kernel, doubling_smem(seg),
                        ZP_PASS);
}

int zp_select_tokens_spec(ZP_ARGS) {
  return launch_variant(select_tokens_spec_kernel, spec_smem(seg), ZP_PASS);
}

#ifdef ZP_PHASES
// the phase clocks of the last launch (the "phase clocks" source copy)
int zp_read_phases(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, zp_phase, n * sizeof(long long));
}
#endif

}  // extern "C"
