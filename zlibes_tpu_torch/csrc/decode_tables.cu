// decode_tables: every coded block's decode-table row for the wide and the
// generic decoders, read straight from the stream's words on the card.
//
// Bit for bit what the host builds in its plain version
// (zlibes_tpu_torch/ops/decode_tables.py): the block's header parsed as
// read_dynamic_code_lengths parses it (zlibes_tpu_torch/spec/refmodel.py;
// a fixed block takes the fixed lengths and reads no bits), then both rows
// of the two-level tables that wide_decode_tables writes
// (zlibes_tpu_torch/ops/wide_kernel.py; the entry encodings are in its
// docstring), with a status a block in place of the host's exceptions.
// The JAX package parses every header on the host: there is no Pallas
// counterpart.
//
// One CTA of 320 threads a block.  The work is latency-bound: a block
// moves ~7 KiB of rows out and reads < 300 B of header, so no byte count
// bounds it; the serial chain of the header's <= 320 code-length symbols
// does.  The design keeps that chain short and runs every block's at once:
//
//  * warp 0 stages the header's words (96 words cover the longest header,
//    2,352 bits from its block's first word) into shared memory in one
//    round trip, and lane 0 reads them through a 64-bit bit buffer: a
//    code-length symbol is one shared-memory lookup in the 7-bit
//    code-length table, which the warp's lanes build four entries each;
//  * everything else is parallel over the block's 320 symbols (a thread
//    each: 288 litlen, 32 distance): length counts by shared atomics, the
//    canonical codes (the lengths below and the rank among equal lengths),
//    short codes replicated across the root, long codes' root prefixes
//    marked with their deepest code (atomicMax), one warp a table scanning
//    the prefixes in ascending order for each sub-table's base (exactly as
//    _fill_two_level assigns them), and the long codes' replicas in their
//    sub-tables; the rows are built in shared memory and leave in
//    coalesced stores.
//
// Status (NB,) int32, 0 where the row is good, else the code of the error
// the host raises first for the block (ops/decode_tables.py STATUS): the
// parse's (a truncated read or code, an invalid code, a repeat with no
// previous length, an RLE overrun), the index's payload start, then for
// the litlen and then the distance table an over-subscribed code (Kraft
// sum above one, CorruptError as canonical_codes_batch raises it) and a
// sub-table overflow.  A row whose status is not 0 is zeros.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -c -Xcompiler -fPIC -o decode_tables.o decode_tables.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 320;    // a thread a symbol: 288 litlen, 32 dist
constexpr int kLitlen = 288;
constexpr int kDist = 32;
static_assert(kThreads == kLitlen + kDist, "a thread a symbol");
constexpr int kStage = 96;       // staged header words
constexpr int kClcSyms = 19;
constexpr int kClcBits = 7;

// the two tables' layout (wide_kernel.py LL_* and D_*)
constexpr int kLlRootBits = 9, kLlRoot = 512, kLlSubOff = 512;
constexpr int kLlSub = 512, kLlW = 1024;
constexpr int kDRootBits = 6, kDRoot = 64, kDSubOff = 128;
constexpr int kDSub = 576, kDW = 768;
constexpr int kSubFlag = 1 << 30;

// status codes, ops/decode_tables.py STATUS (1-based)
constexpr int kTrunc = 1;         // TruncatedError "bit stream overrun"
constexpr int kTruncCode = 2;     // ... "bit stream overrun in Huffman code"
constexpr int kInvalid = 3;       // "invalid Huffman code"
constexpr int kNoPrev = 4;        // "RLE repeat with no previous length"
constexpr int kOverrun = 5;       // "code length RLE overran table size"
constexpr int kMismatch = 6;      // "index does not match stream"
constexpr int kOversub = 7;       // "over-subscribed Huffman code"
constexpr int kSubOverflow = 8;   // "two-level sub-table overflow ..."

__constant__ uint8_t kClcOrder[kClcSyms] = {16, 17, 18, 0, 8,  7, 9,
                                            6,  10, 5,  11, 4, 12, 3,
                                            13, 2,  14, 1,  15};
__constant__ uint16_t kLenBase[29] = {3,  4,  5,  6,   7,   8,   9,   10,
                                      11, 13, 15, 17,  19,  23,  27,  31,
                                      35, 43, 51, 59,  67,  83,  99,  115,
                                      131, 163, 195, 227, 258};
__constant__ uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                      1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                                      4, 4, 4, 4, 5, 5, 5, 5, 0};
__constant__ uint16_t kDistBase[30] = {
    1,    2,    3,    4,    5,    7,     9,     13,    17,    25,
    33,   49,   65,   97,   129,  193,   257,   385,   513,   769,
    1025, 1537, 2049, 3073, 4097, 6145,  8193,  12289, 16385, 24577};
__constant__ uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2,  2,  3,  3,
                                       4, 4, 5, 5, 6, 6, 7,  7,  8,  8,
                                       9, 9, 10, 10, 11, 11, 12, 12, 13,
                                       13};

// LSB-first reader of the header: staged words where it has them, the
// stream's words past them, 0 at and past the stream's last bit (the host
// reader's peek).  pos is absolute; the buffer holds > 32 bits after every
// refill, so a peek of up to 14 bits needs no check.
struct Bits {
  const uint32_t* staged;
  const uint32_t* words;
  int64_t nwords, w0, total;
  uint64_t buf;
  int cnt;
  int64_t next, pos;

  __device__ uint32_t word(int64_t k) const {
    if (k < 0 || k >= nwords || k * 32 >= total) return 0;
    uint32_t w = (uint64_t)(k - w0) < kStage ? staged[k - w0]
                                                : __ldg(words + k);
    const int64_t left = total - k * 32;
    if (left < 32) w &= (1u << left) - 1u;
    return w;
  }
  __device__ void refill() {
    while (cnt <= 32) {
      buf |= (uint64_t)word(next++) << cnt;
      cnt += 32;
    }
  }
  __device__ void start(int64_t p) {
    pos = p;
    next = p >> 5;
    buf = word(next++) >> (p & 31);
    cnt = 32 - (int)(p & 31);
    refill();
  }
  __device__ uint32_t peek(int n) const {
    return (uint32_t)buf & ((1u << n) - 1u);
  }
  __device__ void skip(int n) {
    buf >>= n;
    cnt -= n;
    pos += n;
    refill();
  }
  // read_bits: n bits, or a truncation status
  __device__ bool read(int n, int* v, int* status) {
    if (pos + n > total) {
      *status = kTrunc;
      return false;
    }
    *v = (int)peek(n);
    skip(n);
    return true;
  }
};

__device__ __forceinline__ int length_slot(int i, int hlit) {
  return i < hlit ? i : kLitlen + (i - hlit);
}

__device__ __forceinline__ int fixed_litlen_len(int s) {
  return s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8;
}

// litlen and distance entries of wide_decode_tables
__device__ __forceinline__ int32_t litlen_entry(int sym, int l) {
  if (sym < 256) return l | (sym << 9);
  if (sym == 256) return l | (1 << 4);
  if (sym < 286) {
    const int i = sym - 257;
    return l | (2 << 4) | ((int)kLenExtra[i] << 6) | ((int)kLenBase[i] << 9);
  }
  return l | (3 << 4);
}

__device__ __forceinline__ int32_t dist_entry(int sym, int l) {
  if (sym < 30) return l | ((int)kDistExtra[sym] << 4) | ((int)kDistBase[sym] << 8);
  return 0;
}

// Warp 0 parses a dynamic header at bit p into s_len (zeroed by the
// caller); returns the status (0: good).  Lane 0 reads; the lanes build the
// code-length table together.
__device__ int parse_header(Bits& br, int64_t p, int64_t payload, int lane,
                            uint8_t* s_len, int* s_clc_len, int16_t* s_clc,
                            int* s_hdr) {
  int status = 0;
  if (lane == 0) {
    br.start(p);
    int hlit = 0, hdist = 0, hclen = 0;
    if (br.read(5, &hlit, &status) && br.read(5, &hdist, &status) &&
        br.read(4, &hclen, &status)) {
      hclen += 4;
      for (int s = 0; s < kClcSyms; ++s) s_clc_len[s] = 0;
      for (int i = 0; i < hclen; ++i) {
        int v;
        if (!br.read(3, &v, &status)) break;
        s_clc_len[kClcOrder[i]] = v;
      }
    }
    s_hdr[0] = status;
    s_hdr[1] = hlit + 257;
    s_hdr[2] = hdist + 1;
  }
  __syncwarp();
  status = s_hdr[0];
  if (status) return status;
  // the code-length table as build_decode_table fills it: symbols in
  // ascending order, a later one overwriting an earlier one's entries (an
  // over-subscribed code), -1 where no code fits
  int rev = 0, len = 0;
  if (lane < kClcSyms) {
    len = s_clc_len[lane];
    uint32_t code = 0;
    for (int u = 0; u < kClcSyms; ++u) {
      const int lu = s_clc_len[u];
      if (lu > 0 && lu < len) code += 1u << (len - lu);
      code += lu == len && u < lane;
    }
    if (len) rev = (int)(__brev(code) >> (32 - len));
  }
  for (int idx = lane; idx < (1 << kClcBits); idx += 32) {
    int e = -1;
    for (int s = 0; s < kClcSyms; ++s) {
      const int ls = __shfl_sync(0xffffffffu, len, s);
      const int rs = __shfl_sync(0xffffffffu, rev, s);
      if (ls && (idx & ((1 << ls) - 1)) == rs) e = (s << 4) | ls;
    }
    s_clc[idx] = (int16_t)e;
  }
  __syncwarp();
  if (lane == 0) {
    const int hlit = s_hdr[1], n = hlit + s_hdr[2];
    int i = 0;
    while (i < n) {
      const int e = s_clc[br.peek(kClcBits)];
      if (e < 0) {
        status = kInvalid;
        break;
      }
      const int l = e & 15, sym = e >> 4;
      if (br.pos + l > br.total) {
        status = kTruncCode;
        break;
      }
      br.skip(l);
      if (sym < 16) {
        s_len[length_slot(i++, hlit)] = (uint8_t)sym;
        continue;
      }
      if (sym == 16 && i == 0) {
        status = kNoPrev;
        break;
      }
      const int eb = sym == 16 ? 2 : sym == 17 ? 3 : 7;
      int v;
      if (!br.read(eb, &v, &status)) break;
      const int rep = (sym == 16 ? 3 : sym == 17 ? 3 : 11) + v;
      if (sym == 16) {
        const uint8_t prev = s_len[length_slot(i - 1, hlit)];
        for (int j = i; j < min(i + rep, n); ++j)
          s_len[length_slot(j, hlit)] = prev;
      }
      i += rep;
    }
    if (!status && i != n) status = kOverrun;
    if (!status && payload && br.pos != payload) status = kMismatch;
    s_hdr[0] = status;
  }
  __syncwarp();
  return s_hdr[0];
}

__global__ void __launch_bounds__(kThreads)
decode_tables_kernel(const uint32_t* __restrict__ words, int64_t nwords,
                     int64_t total_bits, const int64_t* __restrict__ hdr,
                     int32_t* __restrict__ lt, int32_t* __restrict__ dt,
                     int32_t* __restrict__ status_out) {
  __shared__ uint32_t s_words[kStage];
  __shared__ uint8_t s_len[kThreads];        // litlen, then distance
  __shared__ int s_clc_len[kClcSyms];
  __shared__ int16_t s_clc[1 << kClcBits];
  __shared__ int s_hdr[3];                   // status, HLIT, HDIST
  __shared__ int s_cnt[2][16];
  __shared__ int s_pmax[kLlRoot + kDRoot];   // deepest code past a prefix
  __shared__ int s_base[kLlRoot + kDRoot];   // its sub-table's base
  __shared__ int s_flags[4];                 // oversub, overflow a table
  __shared__ int32_t s_lt[kLlW];
  __shared__ int32_t s_dt[kDW];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t b = blockIdx.x;
  const int64_t start_bit = hdr[3 * b], payload = hdr[3 * b + 1];
  const int btype = (int)hdr[3 * b + 2];

  for (int i = tid; i < kLlW; i += kThreads) s_lt[i] = 0;
  for (int i = tid; i < kDW; i += kThreads) s_dt[i] = 0;
  for (int i = tid; i < kLlRoot + kDRoot; i += kThreads) s_pmax[i] = 0;
  if (tid < 32) s_cnt[tid >> 4][tid & 15] = 0;
  if (tid < 4) s_flags[tid] = 0;
  s_len[tid] = btype == 1 ? (uint8_t)(tid < kLitlen ? fixed_litlen_len(tid) : 5)
                          : 0;
  if (tid == 0) s_hdr[0] = 0;
  __syncthreads();

  if (btype != 1 && warp == 0) {
    Bits br;
    br.staged = s_words;
    br.words = words;
    br.nwords = nwords;
    br.total = total_bits;
    br.w0 = (start_bit + 3) >> 5;
    for (int k = lane; k < kStage; k += 32) {
      const int64_t w = br.w0 + k;
      s_words[k] = w < nwords ? __ldg(words + w) : 0u;
    }
    __syncwarp();
    parse_header(br, start_bit + 3, payload, lane, s_len, s_clc_len, s_clc,
                 s_hdr);
  }
  __syncthreads();

  const int err = s_hdr[0];
  if (!err) {
    const bool is_d = tid >= kLitlen;
    const int sym = is_d ? tid - kLitlen : tid;
    const int l = s_len[tid];
    const int root_bits = is_d ? kDRootBits : kLlRootBits;
    const int root = 1 << root_bits;
    int* cnt = s_cnt[is_d];
    int* pmax = s_pmax + (is_d ? kLlRoot : 0);
    int* pbase = s_base + (is_d ? kLlRoot : 0);
    int32_t* tab = is_d ? s_dt : s_lt;
    if (l) atomicAdd(&cnt[l], 1);
    __syncthreads();
    if (tid < 2) {  // Kraft sums above one
      int k = 0;
      for (int j = 1; j < 16; ++j) k += s_cnt[tid][j] << (15 - j);
      s_flags[tid] = k > (1 << 15);
    }
    // the canonical code: the codes of shorter lengths, then the rank
    // among the equal lengths below the symbol
    uint32_t code = 0;
    if (l) {
      for (int j = 1; j < l; ++j) code += (uint32_t)cnt[j] << (l - j);
      const uint8_t* lens = s_len + (is_d ? kLitlen : 0);
      for (int u = 0; u < sym; ++u) code += lens[u] == l;
    }
    const int rev = l ? (int)(__brev(code) >> (32 - l)) : 0;
    const int32_t e = is_d ? dist_entry(sym, l) : litlen_entry(sym, l);
    if (l && l <= root_bits) {
      for (int idx = rev; idx < root; idx += 1 << l) tab[idx] = e;
    } else if (l) {
      atomicMax(&pmax[rev & (root - 1)], l - root_bits);
    }
    __syncthreads();
    // warp 0 the litlen prefixes, warp 1 the distance ones: each sub-table's
    // base is the spans of the prefixes below it; the root holds a pointer
    if (warp < 2) {
      const bool d = warp == 1;
      const int nroot = d ? kDRoot : kLlRoot;
      const int per = nroot / 32;
      int* pm = s_pmax + (d ? kLlRoot : 0);
      int* pb = s_base + (d ? kLlRoot : 0);
      int32_t* t = d ? s_dt : s_lt;
      int sum = 0;
      for (int q = lane * per; q < (lane + 1) * per; ++q)
        sum += pm[q] ? 1 << pm[q] : 0;
      int incl = sum;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const int total = __shfl_sync(0xffffffffu, incl, 31);
      const bool overflow = total > (d ? kDSub : kLlSub);
      int at = incl - sum;
      for (int q = lane * per; q < (lane + 1) * per; ++q) {
        if (!pm[q]) continue;
        pb[q] = at;
        if (!overflow)
          t[q] = d ? (kSubFlag | (at << 8) | (pm[q] << 24))
                   : (kSubFlag | pm[q] | (at << 9));
        at += 1 << pm[q];
      }
      if (lane == 0) s_flags[2 + warp] = overflow;
    }
    __syncthreads();
    if (l > root_bits && !s_flags[2 + is_d]) {
      const int q = rev & (root - 1);
      const int span = 1 << pmax[q];
      const int off = (is_d ? kDSubOff : kLlSubOff) + pbase[q];
      for (int idx = rev >> root_bits; idx < span; idx += 1 << (l - root_bits))
        tab[off + idx] = e;
    }
    __syncthreads();
  }

  const int st = err                ? err
                 : s_flags[0]       ? kOversub
                 : s_flags[2]       ? kSubOverflow
                 : s_flags[1]       ? kOversub
                 : s_flags[3]       ? kSubOverflow
                                    : 0;
  int32_t* lrow = lt + b * kLlW;
  int32_t* drow = dt + b * kDW;
  for (int i = tid; i < kLlW; i += kThreads) lrow[i] = st ? 0 : s_lt[i];
  for (int i = tid; i < kDW; i += kThreads) drow[i] = st ? 0 : s_dt[i];
  if (tid == 0) status_out[b] = st;
}

}  // namespace

extern "C" {

// hdr: (nb, 3) int64 a block's start bit, payload start bit (0: unknown)
// and btype; lt (nb, 1024), dt (nb, 768), status (nb,) int32
int zt_decode_tables(const void* words, int64_t nwords, int64_t total_bits,
                     const void* hdr, int nb, void* lt, void* dt,
                     void* status, void* stream) {
  decode_tables_kernel<<<(unsigned)nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, nwords, total_bits, (const int64_t*)hdr,
      (int32_t*)lt, (int32_t*)dt, (int32_t*)status);
  return (int)cudaGetLastError();
}

}  // extern "C"
