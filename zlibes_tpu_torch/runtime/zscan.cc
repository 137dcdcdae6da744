// Native host runtime: DEFLATE structure scanner + LZ resolver.
//
// Role in the framework (foreign streams): block boundaries
// of a foreign zlib stream are only discoverable by decoding, which is
// bit-serial — the one part of inflate that cannot be data-parallel on
// device.  This scanner runs that sequential pass at C speed, emitting
//   * per-block structure records (the StreamIndex a future decode reuses),
//   * sync anchors every ~4 KiB of output (token-boundary bit/out offsets),
//   * the token stream (literal/length/dist), ready for device LZ resolve,
// plus a sequential resolver used as the host-only fallback codec.
//
// Decode tables are two-level canonical lookups (2^10 root + subtables,
// so the hot table stays L1-resident); the input buffer must be readable
// for 8 bytes past its logical end (native.py pads its copy) so the bit
// reader is a single unaligned 64-bit load per symbol.  No code is
// derived from the reference implementation (reference is TypeScript;
// this is a fresh RFC 1951 implementation).
//
// Build: g++ -O3 -shared -fPIC zscan.cc -o libzscan.so   (see native.py)

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <atomic>
#include <condition_variable>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int kMaxBits = 15;
// two-level decode tables (zlib-style): a 2^10 root stays L1-resident —
// the flat 2^15 table this replaces missed cache on nearly every symbol
constexpr int kRootBits = 10;
constexpr int kRootSize = 1 << kRootBits;
constexpr uint32_t kRootMask = kRootSize - 1;
constexpr int32_t kLongFlag = 1 << 30;

// RFC 1951 §3.2.5 tables
const int kLenBase[29] = {3,4,5,6,7,8,9,10,11,13,15,17,19,23,27,31,35,43,51,
                          59,67,83,99,115,131,163,195,227,258};
const int kLenExtra[29] = {0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2,3,3,3,3,4,4,4,4,
                           5,5,5,5,0};
const int kDistBase[30] = {1,2,3,4,5,7,9,13,17,25,33,49,65,97,129,193,257,385,
                           513,769,1025,1537,2049,3073,4097,6145,8193,12289,
                           16385,24577};
const int kDistExtra[30] = {0,0,0,0,1,1,2,2,3,3,4,4,5,5,6,6,7,7,8,8,9,9,10,10,
                            11,11,12,12,13,13};
const int kClcOrder[19] = {16,17,18,0,8,7,9,6,10,5,11,4,12,3,13,2,14,1,15};

struct BitReader {
  const uint8_t* data;  // caller guarantees 8 readable bytes past the
                        // logical end (native.py pads its copy)
  size_t nbits;
  size_t pos;  // bit position
  bool overrun;

  uint64_t peek64() const {
    // LSB-first 57+ bit window at pos (single unaligned 8-byte load; the
    // padding contract makes the tail branch-free)
    uint64_t w;
    memcpy(&w, data + (pos >> 3), 8);
    return w >> (pos & 7);
  }
  uint32_t peek(int n) { return (uint32_t)peek64() & ((1u << n) - 1); }
  uint32_t get(int n) {
    if (pos + n > nbits) { overrun = true; return 0; }
    uint32_t v = peek(n);
    pos += n;
    return v;
  }
  void align() { pos = (pos + 7) & ~(size_t)7; }
};

// two-level canonical decode table.  Root entry for codes ≤ kRootBits:
// sym | (len << 16); long root entry: kLongFlag | (sub_width << 24) |
// sub_base; sub entry: sym | (len << 16) with the FULL code length.
// entry 0 = invalid bit pattern.
struct Table {
  int32_t root[kRootSize];
  int32_t sub[1 << kMaxBits];  // worst-case Kraft bound; used prefix only
};

inline int32_t table_lookup(const Table& t, uint64_t w) {
  int32_t e = t.root[(uint32_t)w & kRootMask];
  if (e & kLongFlag)
    e = t.sub[(e & 0xFFFFF)
              + (((uint32_t)(w >> kRootBits)) & ((1u << ((e >> 24) & 15)) - 1))];
  return e;
}

bool build_table(const uint8_t* lens, int n, Table* t) {
  int bl_count[kMaxBits + 1] = {0};
  for (int i = 0; i < n; i++) bl_count[lens[i]]++;
  bl_count[0] = 0;
  // Kraft check
  long kraft = 0;
  for (int l = 1; l <= kMaxBits; l++) kraft += (long)bl_count[l] << (kMaxBits - l);
  if (kraft > (1L << kMaxBits)) return false;
  int next_code0[kMaxBits + 2] = {0};
  int code = 0;
  for (int l = 1; l <= kMaxBits; l++) {
    code = (code + bl_count[l - 1]) << 1;
    next_code0[l] = code;
  }
  memset(t->root, 0, sizeof(t->root));
  // pass 1: per-root-slot sub-table width for long codes
  uint8_t sub_bits[kRootSize];
  memset(sub_bits, 0, sizeof(sub_bits));
  int nc[kMaxBits + 2];
  memcpy(nc, next_code0, sizeof(nc));
  bool any_long = false;
  for (int s = 0; s < n; s++) {
    int l = lens[s];
    if (l <= kRootBits) { if (l) nc[l]++; continue; }
    any_long = true;
    int c = nc[l]++;
    int r = 0;
    for (int b = 0; b < l; b++) { r = (r << 1) | (c & 1); c >>= 1; }
    uint32_t slot = (uint32_t)r & kRootMask;
    if (l - kRootBits > sub_bits[slot]) sub_bits[slot] = (uint8_t)(l - kRootBits);
  }
  int32_t slot_base[kRootSize];
  if (any_long) {
    int base = 0;
    for (int slot = 0; slot < kRootSize; slot++) {
      if (!sub_bits[slot]) continue;
      int sz = 1 << sub_bits[slot];
      memset(t->sub + base, 0, (size_t)sz * 4);
      t->root[slot] = kLongFlag | (sub_bits[slot] << 24) | base;
      slot_base[slot] = base;
      base += sz;
    }
  }
  // pass 2: fill
  memcpy(nc, next_code0, sizeof(nc));
  for (int s = 0; s < n; s++) {
    int l = lens[s];
    if (!l) continue;
    int c = nc[l]++;
    int r = 0;
    for (int b = 0; b < l; b++) { r = (r << 1) | (c & 1); c >>= 1; }
    int32_t e = s | (l << 16);
    if (l <= kRootBits) {
      for (int idx = r; idx < kRootSize; idx += 1 << l) t->root[idx] = e;
    } else {
      uint32_t slot = (uint32_t)r & kRootMask;
      int sb = sub_bits[slot];
      int idx = r >> kRootBits;  // (l - kRootBits) significant bits
      for (int k = idx; k < (1 << sb); k += 1 << (l - kRootBits))
        t->sub[slot_base[slot] + k] = e;
    }
  }
  return true;
}

struct BlockRec {
  int64_t btype, bfinal;
  int64_t start_bit, payload_start_bit, end_bit;
  int64_t out_start, out_len;
  int64_t tok_start, tok_count;  // token range (stored blocks: raw range)
};

}  // namespace

namespace {

// scan context: caller-provided output buffers + running counters.
struct ScanCtx {
  int32_t* toks_val; int32_t* toks_dist; int64_t max_toks;
  BlockRec* blocks; int64_t max_blocks;
  int64_t* anchor_bit; int64_t* anchor_out; int32_t* anchor_block;
  int64_t max_anchors; int64_t anchor_every;
  int64_t ntok = 0, nblk = 0, nanch = 0, out = 0, crossing = 0;
};

enum {
  Z_OK_ = 0, Z_DONE_ = 1, Z_STOP_ = 2,
  ZE_BTYPE = -1, ZE_TRUNC = -2, ZE_STORED = -3, ZE_CORRUPT = -4,
  ZE_TOK_CAP = -5, ZE_BLK_CAP = -6, ZE_ANCH_CAP = -7,
};

// Scan whole DEFLATE blocks from br.pos.  Stops after the first block
// whose end bit is >= stop_bit (returning Z_STOP_), or after a BFINAL
// block (Z_DONE_).  ``speculative`` relaxes the back-reference distance
// check to the format bound (a speculative span cannot know how much
// output precedes it; the merge step re-validates its head) — rapidgzip-
// style span speculation (PAPERS.md), reimplemented from RFC 1951.
int scan_core(BitReader& br, ScanCtx& C, size_t stop_bit, bool speculative,
              int64_t dict_len) {
  static thread_local Table litlen_tab, dist_tab;
  for (;;) {
    if (C.nblk >= C.max_blocks) return ZE_BLK_CAP;
    BlockRec& B = C.blocks[C.nblk];
    B.start_bit = (int64_t)br.pos;
    B.out_start = C.out;
    B.tok_start = C.ntok;
    uint32_t bfinal = br.get(1);
    uint32_t btype = br.get(2);
    if (br.overrun) return ZE_TRUNC;
    B.bfinal = bfinal;
    B.btype = btype;
    if (btype == 0) {  // stored
      br.align();
      B.payload_start_bit = (int64_t)br.pos;
      size_t byte = br.pos >> 3;
      if ((byte + 4) * 8 > br.nbits) return ZE_TRUNC;
      const uint8_t* data = br.data;
      uint32_t len = data[byte] | ((uint32_t)data[byte + 1] << 8);
      uint32_t nlen = data[byte + 2] | ((uint32_t)data[byte + 3] << 8);
      if (len != (~nlen & 0xFFFF)) return ZE_STORED;
      byte += 4;
      if ((byte + len) * 8 > br.nbits) return ZE_TRUNC;
      if (C.ntok + len > C.max_toks) return ZE_TOK_CAP;
      for (uint32_t i = 0; i < len; i++) {
        C.toks_val[C.ntok] = data[byte + i];
        C.toks_dist[C.ntok] = 0;
        C.ntok++;
      }
      C.out += len;
      br.pos = (byte + len) * 8;
    } else if (btype == 1 || btype == 2) {
      if (btype == 1) {
        uint8_t ll[288], dd[32];
        for (int i = 0; i < 288; i++)
          ll[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
        for (int i = 0; i < 32; i++) dd[i] = 5;
        build_table(ll, 288, &litlen_tab);
        build_table(dd, 32, &dist_tab);
      } else {
        uint32_t hlit = br.get(5) + 257;
        uint32_t hdist = br.get(5) + 1;
        uint32_t hclen = br.get(4) + 4;
        uint8_t clc[19] = {0};
        for (uint32_t i = 0; i < hclen; i++) clc[kClcOrder[i]] = br.get(3);
        if (br.overrun) return ZE_TRUNC;
        static thread_local Table clc_tab;
        if (!build_table(clc, 19, &clc_tab)) return ZE_CORRUPT;
        uint8_t lens[288 + 32] = {0};
        uint32_t i = 0;
        while (i < hlit + hdist) {
          int32_t e = table_lookup(clc_tab, br.peek64());
          int l = e >> 16;
          if (!l) return ZE_CORRUPT;
          if (br.pos + l > br.nbits) return ZE_TRUNC;
          br.pos += l;
          int sym = e & 0xFFFF;
          if (sym < 16) {
            lens[i++] = (uint8_t)sym;
          } else if (sym == 16) {
            if (i == 0) return ZE_CORRUPT;
            uint32_t rep = 3 + br.get(2);
            if (i + rep > hlit + hdist) return ZE_CORRUPT;
            uint8_t v = lens[i - 1];
            for (uint32_t k = 0; k < rep; k++) lens[i++] = v;
          } else if (sym == 17) {
            uint32_t rep = 3 + br.get(3);
            if (i + rep > hlit + hdist) return ZE_CORRUPT;
            i += rep;
          } else {
            uint32_t rep = 11 + br.get(7);
            if (i + rep > hlit + hdist) return ZE_CORRUPT;
            i += rep;
          }
          if (br.overrun) return ZE_TRUNC;
        }
        if (!build_table(lens, hlit, &litlen_tab)) return ZE_CORRUPT;
        if (!build_table(lens + hlit, hdist, &dist_tab)) return ZE_CORRUPT;
      }
      B.payload_start_bit = (int64_t)br.pos;
      int64_t next_anchor = C.out;  // first anchor at payload start
      for (;;) {
        if (C.anchor_every > 0 && C.out >= next_anchor) {
          if (C.nanch >= C.max_anchors) return ZE_ANCH_CAP;
          C.anchor_bit[C.nanch] = (int64_t)br.pos;
          C.anchor_out[C.nanch] = C.out;
          C.anchor_block[C.nanch] = (int32_t)C.nblk;
          C.nanch++;
          next_anchor = C.out + C.anchor_every;
        }
        uint64_t w = br.peek64();
        int32_t e = table_lookup(litlen_tab, w);
        int l = (e >> 16) & 31;
        if (!l) return ZE_CORRUPT;
        if (br.pos + l > br.nbits) return ZE_TRUNC;
        int sym = e & 0xFFFF;
        if (sym < 256) {
          br.pos += l;
          if (C.ntok >= C.max_toks) return ZE_TOK_CAP;
          C.toks_val[C.ntok] = sym;
          C.toks_dist[C.ntok] = 0;
          C.ntok++;
          C.out++;
        } else if (sym == 256) {
          br.pos += l;
          break;
        } else {
          if (sym > 285) return ZE_CORRUPT;
          int li = sym - 257;
          int lex = kLenExtra[li];
          // length extras ride the same 57-bit window (l + lex <= 20)
          uint32_t length =
              kLenBase[li] + (uint32_t)((w >> l) & ((1u << lex) - 1));
          if (br.pos + l + lex > br.nbits) return ZE_TRUNC;
          br.pos += l + lex;
          uint64_t w2 = br.peek64();
          int32_t de = table_lookup(dist_tab, w2);
          int dl = (de >> 16) & 31;
          if (!dl) return ZE_CORRUPT;
          int dsym = de & 0xFFFF;
          if (dsym > 29) return ZE_CORRUPT;
          int dex = kDistExtra[dsym];
          // dist code + extras fit the window too (dl + dex <= 28)
          uint32_t dist =
              kDistBase[dsym] + (uint32_t)((w2 >> dl) & ((1u << dex) - 1));
          if (br.pos + dl + dex > br.nbits) return ZE_TRUNC;
          br.pos += dl + dex;
          if (!speculative && (int64_t)dist > C.out + dict_len)
            return ZE_CORRUPT;
          if ((int64_t)dist > C.out - B.out_start) C.crossing = 1;
          if (C.ntok >= C.max_toks) return ZE_TOK_CAP;
          C.toks_val[C.ntok] = (int32_t)length;
          C.toks_dist[C.ntok] = (int32_t)dist;
          C.ntok++;
          C.out += length;
        }
      }
    } else {
      return ZE_BTYPE;
    }
    B.end_bit = (int64_t)br.pos;
    B.out_len = C.out - B.out_start;
    B.tok_count = C.ntok - B.tok_start;
    C.nblk++;
    if (bfinal) return Z_DONE_;
    if (br.pos >= stop_bit) return Z_STOP_;
  }
}

// cheap candidate pre-filter at a bit offset: plausible block header?
// (btype 2 with in-range HLIT/HDIST and a non-oversubscribed precode, or
// a stored block with a valid LEN/NLEN pair; fixed blocks are not
// searched for — any bit pattern parses as one, so they carry no signal)
bool plausible_header(const uint8_t* data, size_t nbits, size_t bit) {
  uint64_t w;
  // a run of zero-length stored blocks is walked in this loop, one header
  // a turn, however long it is: the answer is that of the first header
  // after the run
  for (;;) {
    if (bit + 3 > nbits) return false;
    // one unaligned load serves the first 57 bits; candidates die on
    // btype/HLIT/HDIST within it, so the common case is a single memcpy
    memcpy(&w, data + (bit >> 3), 8);
    w >>= bit & 7;
    uint32_t btype = (uint32_t)(w >> 1) & 3;
    if (btype == 2) break;
    if (btype != 0) return false;
    size_t byte = ((bit + 3) + 7) >> 3;
    if ((byte + 4) * 8 > nbits) return false;
    uint32_t len = data[byte] | ((uint32_t)data[byte + 1] << 8);
    uint32_t nlen = data[byte + 2] | ((uint32_t)data[byte + 3] << 8);
    if (len != (~nlen & 0xFFFF)) return false;
    if (len > 0) return true;
    // zero-length stored blocks are real: they are this encoder's own
    // byte-align sync blocks and zlib's Z_SYNC_FLUSH/Z_FULL_FLUSH markers,
    // and span boundaries land on them on exactly the flush-marked streams
    // the parallel scan targets.  Their 32 header bits carry
    // no signal, so chain the check: require a plausible FOLLOWING header
    // to keep the false-positive rate down.
    bit = (byte + 4) * 8;
    if (bit >= nbits) return false;
  }
  uint32_t hlit = (uint32_t)(w >> 3) & 31;
  uint32_t hdist = (uint32_t)(w >> 8) & 31;
  if (hlit > 29 || hdist > 29) return false;
  uint32_t hclen = ((uint32_t)(w >> 13) & 15) + 4;
  if (bit + 17 + hclen * 3 > nbits) return false;
  // precode Kraft pre-check (oversubscription kills ~99% of noise).
  // The 3-bit lengths span bits [17, 17 + 3*hclen) <= 74: the first 13
  // ride the loaded window, the rest come from one more load.
  long kraft = 0;
  int nz = 0;
  uint64_t lens = w >> 17;  // 40 valid bits -> 13 whole entries
  uint32_t n0 = hclen < 13 ? hclen : 13;
  for (uint32_t i = 0; i < n0; i++) {
    uint32_t v = (uint32_t)(lens >> (i * 3)) & 7;
    if (v) { kraft += 1L << (7 - v); nz++; }
  }
  if (hclen > 13) {
    size_t bit2 = bit + 17 + 39;
    uint64_t w2;
    memcpy(&w2, data + (bit2 >> 3), 8);
    w2 >>= bit2 & 7;
    for (uint32_t i = 13; i < hclen; i++) {
      uint32_t v = (uint32_t)(w2 >> ((i - 13) * 3)) & 7;
      if (v) { kraft += 1L << (7 - v); nz++; }
    }
  }
  return nz >= 1 && kraft == (1L << 7);  // real encoders emit COMPLETE
                                         // precodes; require exactness
}

// full lightweight dynamic-header validation: tiny 128-entry precode
// table + code-length RLE parse + litlen/dist completeness — rejects
// essentially all random bit positions that slip past plausible_header,
// so scan_core (with its 4 KB root-table builds) only runs on candidates
// that are almost certainly real block starts.
bool try_header_dyn(const uint8_t* data, size_t nbits, size_t bit) {
  BitReader br{data, nbits, bit + 3, false};
  uint32_t hlit = br.get(5) + 257;
  uint32_t hdist = br.get(5) + 1;
  uint32_t hclen = br.get(4) + 4;
  uint8_t clc[19] = {0};
  for (uint32_t i = 0; i < hclen; i++) clc[kClcOrder[i]] = br.get(3);
  if (br.overrun) return false;
  // canonical 7-bit precode table (LSB-first indexed)
  int bl[8] = {0};
  for (int i = 0; i < 19; i++) bl[clc[i]]++;
  bl[0] = 0;
  long kraft = 0;
  for (int l = 1; l <= 7; l++) kraft += (long)bl[l] << (7 - l);
  if (kraft != (1L << 7)) return false;
  int next[9] = {0};
  int code = 0;
  for (int l = 1; l <= 7; l++) {
    code = (code + bl[l - 1]) << 1;
    next[l] = code;
  }
  int8_t sym_of[128];
  int8_t len_of[128];
  memset(len_of, 0, sizeof(len_of));
  for (int s = 0; s < 19; s++) {
    int l = clc[s];
    if (!l) continue;
    int c = next[l]++;
    int r = 0;
    for (int b = 0; b < l; b++) { r = (r << 1) | (c & 1); c >>= 1; }
    for (int idx = r; idx < 128; idx += 1 << l) {
      sym_of[idx] = (int8_t)s;
      len_of[idx] = (int8_t)l;
    }
  }
  // parse the code-length sequence
  uint8_t nz_count[16] = {0};
  uint8_t dnz[16] = {0};
  uint32_t i = 0;
  uint8_t prev = 0;
  bool have_prev = false;
  while (i < hlit + hdist) {
    uint32_t w = (uint32_t)br.peek64() & 127;
    int l = len_of[w];
    if (!l) return false;
    if (br.pos + l > nbits) return false;
    br.pos += l;
    int sym = sym_of[w];
    uint32_t rep = 1;
    uint8_t v = 0;
    if (sym < 16) {
      v = (uint8_t)sym;
      have_prev = true;
      prev = v;
    } else if (sym == 16) {
      if (!have_prev) return false;
      rep = 3 + br.get(2);
      v = prev;
    } else if (sym == 17) {
      rep = 3 + br.get(3);
      v = 0;
    } else {
      rep = 11 + br.get(7);
      v = 0;
    }
    if (br.overrun || i + rep > hlit + hdist) return false;
    for (uint32_t k = 0; k < rep; k++) {
      uint32_t at = i + k;
      if (v) {
        if (at < hlit) nz_count[v]++; else dnz[v]++;
      }
    }
    i += rep;
  }
  // litlen code must be complete (canonical zlib: "invalid literal/
  // lengths set"); dist may be incomplete only for <= 1 code
  long kl = 0;
  long nd = 0;
  long kd = 0;
  for (int l = 1; l <= 15; l++) {
    kl += (long)nz_count[l] << (15 - l);
    kd += (long)dnz[l] << (15 - l);
    nd += dnz[l];
  }
  if (kl != (1L << 15)) return false;
  if (nd > 1 && kd != (1L << 15)) return false;
  return true;
}

}  // namespace

extern "C" {

// result codes
enum {
  Z_OK = 0, Z_ERR_BTYPE = -1, Z_ERR_TRUNC = -2, Z_ERR_STORED = -3,
  Z_ERR_CORRUPT = -4, Z_ERR_TOK_CAP = -5, Z_ERR_BLK_CAP = -6,
  Z_ERR_ANCH_CAP = -7,
};

// Scan a raw DEFLATE stream starting at bit_offset (sequential).
// toks_*: token output (val = literal byte or match length; dist = 0 for
// literals).  Stored-block bytes are emitted as literal tokens.
// Returns Z_OK or error; fills counts through out params.
int zscan(const uint8_t* data, int64_t nbytes, int64_t bit_offset,
          int32_t* toks_val, int32_t* toks_dist, int64_t max_toks,
          BlockRec* blocks, int64_t max_blocks,
          int64_t* anchor_bit, int64_t* anchor_out, int32_t* anchor_block,
          int64_t max_anchors, int64_t anchor_every, int64_t dict_len,
          int64_t* n_toks_out, int64_t* n_blocks_out, int64_t* n_anchors_out,
          int64_t* end_bit_out, int64_t* out_len_out,
          int64_t* crossing_out) {
  BitReader br{data, (size_t)nbytes * 8, (size_t)bit_offset, false};
  ScanCtx C{toks_val, toks_dist, max_toks, blocks, max_blocks,
            anchor_bit, anchor_out, anchor_block, max_anchors, anchor_every};
  int rc = scan_core(br, C, (size_t)-1, false, dict_len);
  if (rc < 0) return rc;
  *n_toks_out = C.ntok;
  *n_blocks_out = C.nblk;
  *n_anchors_out = C.nanch;
  *end_bit_out = (int64_t)br.pos;
  *out_len_out = C.out;
  *crossing_out = C.crossing;
  return Z_OK;
}

namespace {

// per-worker speculative result (uninitialized new[] buffers: vector
// resize() would zero tens of MB per scan)
struct SpecResult {
  bool found = false;
  bool final_seen = false;
  size_t cand_bit = 0;
  size_t end_bit = 0;
  std::unique_ptr<int32_t[]> tv, td;
  std::unique_ptr<BlockRec[]> blk;
  std::unique_ptr<int64_t[]> abit, aout;
  std::unique_ptr<int32_t[]> ablk;
  int64_t ntok = 0, nblk = 0, nanch = 0;
  int64_t out = 0, crossing = 0;
};

// Search span [sbit, ebit) for a decodable block chain; on success the
// worker's result holds every whole block from cand_bit to the first
// block end >= ebit (or the BFINAL end).
void spec_worker(const uint8_t* data, size_t nbits, size_t sbit, size_t ebit,
                 int64_t anchor_every, int64_t span_bytes, SpecResult* R) {
  int64_t tok_cap = span_bytes * 3 + (1 << 16);
  int64_t blk_cap = span_bytes / 512 + 64;
  int64_t anch_cap =
      (anchor_every > 0 ? tok_cap / (anchor_every / 4 + 1) : 0) + 1024;
  R->tv.reset(new int32_t[tok_cap]);
  R->td.reset(new int32_t[tok_cap]);
  R->blk.reset(new BlockRec[blk_cap]);
  R->abit.reset(new int64_t[anch_cap]);
  R->aout.reset(new int64_t[anch_cap]);
  R->ablk.reset(new int32_t[anch_cap]);
  for (size_t bit = sbit; bit < ebit; bit++) {
    if (!plausible_header(data, nbits, bit)) continue;
    // dynamic candidates get the full light header validation; stored
    // candidates already passed the LEN/NLEN filter
    uint64_t w0;
    memcpy(&w0, data + (bit >> 3), 8);
    if ((((uint32_t)(w0 >> (bit & 7)) >> 1) & 3) == 2
        && !try_header_dyn(data, nbits, bit)) continue;
    BitReader br{data, nbits, bit, false};
    ScanCtx C{R->tv.get(), R->td.get(), tok_cap, R->blk.get(), blk_cap,
              R->abit.get(), R->aout.get(), R->ablk.get(), anch_cap,
              anchor_every};
    int rc = scan_core(br, C, ebit, true, 0);
    if (rc == Z_DONE_ || rc == Z_STOP_) {
      R->found = true;
      R->final_seen = (rc == Z_DONE_);
      R->cand_bit = bit;
      R->end_bit = br.pos;
      R->out = C.out;
      R->crossing = C.crossing;
      R->ntok = C.ntok;
      R->nblk = C.nblk;
      R->nanch = C.nanch;
      return;
    }
    // cap overruns mean the speculation budget is too small, not that the
    // stream is corrupt — give up and let the serial fallback cover this
    // span
    if (rc == ZE_TOK_CAP || rc == ZE_BLK_CAP || rc == ZE_ANCH_CAP) return;
  }
}

}  // namespace

// Speculative-parallel structure scan (rapidgzip-style span speculation;
// PAPERS.md): the stream splits into ~span_bytes compressed spans, worker
// threads search each span start for a decodable block boundary and scan
// ahead speculatively, and the merge loop splices a span whenever its
// candidate bit equals the authoritative chain end — falling back to a
// serial rescan of just that span otherwise.  Output is bit-identical to
// zscan.  Returns Z_OK or error.
namespace {

// token-range resolve shared by zresolve and the pipelined decoder;
// advances *o and folds the produced bytes into a running Adler-32
// (same cache-hot pass)
int resolve_range(const int32_t* toks_val, const int32_t* toks_dist,
                  int64_t t0, int64_t t1, uint8_t* out, int64_t out_cap,
                  int64_t* o_io, uint32_t* s1_io, uint32_t* s2_io) {
  int64_t o = *o_io;
  int64_t a0 = o;
  for (int64_t t = t0; t < t1; t++) {
    int32_t d = toks_dist[t];
    if (d == 0) {
      if (o >= out_cap) return -9;
      out[o++] = (uint8_t)toks_val[t];
    } else {
      int64_t len = toks_val[t];
      if (d > o) return -4;
      if (o + len > out_cap) return -9;
      const uint8_t* src = out + o - d;
      uint8_t* dst = out + o;
      if (d >= len) {
        memcpy(dst, src, (size_t)len);
      } else {
        memcpy(dst, src, (size_t)d);
        int64_t done = d;
        while (done < len) {
          int64_t c = done < len - done ? done : len - done;
          memcpy(dst + done, dst, (size_t)c);
          done += c;
        }
      }
      o += len;
    }
  }
  uint32_t s1 = *s1_io, s2 = *s2_io;
  int64_t i = a0;
  while (i < o) {
    int64_t blk = o - i < 5552 ? o - i : 5552;
    for (int64_t k = 0; k < blk; k++) { s1 += out[i + k]; s2 += s1; }
    s1 %= 65521; s2 %= 65521;
    i += blk;
  }
  *o_io = o;
  *s1_io = s1;
  *s2_io = s2;
  return 0;
}

}  // namespace

namespace {

// merge-progress channel between the scan and the pipelined resolver
struct Progress {
  std::mutex m;
  std::condition_variable cv;
  int64_t frontier = 0;  // tokens fully merged into the output arrays
  bool done = false;
  void publish(int64_t f) {
    { std::lock_guard<std::mutex> lk(m); if (f > frontier) frontier = f; }
    cv.notify_one();
  }
  void finish() {
    { std::lock_guard<std::mutex> lk(m); done = true; }
    cv.notify_one();
  }
};

int scan_parallel_impl(const uint8_t* data, int64_t nbytes,
                   int64_t bit_offset,
                   int32_t* toks_val, int32_t* toks_dist, int64_t max_toks,
                   BlockRec* blocks, int64_t max_blocks,
                   int64_t* anchor_bit, int64_t* anchor_out,
                   int32_t* anchor_block,
                   int64_t max_anchors, int64_t anchor_every,
                   int64_t dict_len,
                   int64_t nthreads, int64_t span_bytes,
                   int64_t* n_toks_out, int64_t* n_blocks_out,
                   int64_t* n_anchors_out,
                   int64_t* end_bit_out, int64_t* out_len_out,
                   int64_t* crossing_out, int64_t* spliced_out,
                   Progress* prog) {
  size_t nbits = (size_t)nbytes * 8;
  if (nthreads <= 0) nthreads = (int64_t)std::thread::hardware_concurrency();
  if (nthreads < 1) nthreads = 1;
  if (span_bytes < (1 << 16)) span_bytes = 1 << 16;
  int64_t start_byte = bit_offset / 8;
  int64_t nspans = (nbytes - start_byte + span_bytes - 1) / span_bytes;
  if (nspans < 2 || nthreads < 2) {
    *spliced_out = 0;
    if (!prog) {
      return zscan(data, nbytes, bit_offset, toks_val, toks_dist, max_toks,
                   blocks, max_blocks, anchor_bit, anchor_out, anchor_block,
                   max_anchors, anchor_every, dict_len, n_toks_out,
                   n_blocks_out, n_anchors_out, end_bit_out, out_len_out,
                   crossing_out);
    }
    // pipelined serial scan: publish the token frontier every ~256 KiB
    // of compressed input so the trailing resolver overlaps even when
    // only one scan thread runs (the 2-core case: one core scans, the
    // other resolves+checksums)
    BitReader br0{data, nbits, (size_t)bit_offset, false};
    ScanCtx C0{toks_val, toks_dist, max_toks, blocks, max_blocks,
               anchor_bit, anchor_out, anchor_block, max_anchors,
               anchor_every};
    int rc0;
    do {
      rc0 = scan_core(br0, C0, br0.pos + (256u << 13), false, dict_len);
      if (rc0 < 0) return rc0;
      prog->publish(C0.ntok);
    } while (rc0 != Z_DONE_);
    *n_toks_out = C0.ntok;
    *n_blocks_out = C0.nblk;
    *n_anchors_out = C0.nanch;
    *end_bit_out = (int64_t)br0.pos;
    *out_len_out = C0.out;
    *crossing_out = C0.crossing;
    return Z_OK;
  }

  // Spans speculate in WAVES of a few per worker, and every span's
  // buffers are released as soon as it is spliced or rescanned: the
  // speculative arrays cost ~24 bytes per compressed byte, so scanning
  // every span of a multi-GB stream at once would transiently allocate
  // tens of GB.  Peak memory is O(wave * span_bytes) — with
  // the 8 MiB span cap (native.py), <= ~770 MB/worker worst case.  Four
  // spans per worker keep the pool busy across the merge barrier (two
  // per worker measurably idled it back to serial speed).
  int64_t nworkers = nthreads - 1 < nspans - 1 ? nthreads - 1 : nspans - 1;
  int64_t wave = nworkers * 4 < 4 ? 4 : nworkers * 4;

  ScanCtx C{toks_val, toks_dist, max_toks, blocks, max_blocks,
            anchor_bit, anchor_out, anchor_block, max_anchors, anchor_every};
  BitReader br{data, nbits, (size_t)bit_offset, false};
  size_t stop0 = (size_t)(start_byte + span_bytes) * 8;
  int rc = Z_STOP_;
  int64_t spliced = 0;
  bool first = true;

  for (int64_t w0 = 1; w0 < nspans && rc != Z_DONE_; ) {
    int64_t w1 = w0 + wave < nspans ? w0 + wave : nspans;
    std::vector<SpecResult> res((size_t)(w1 - w0));
    std::vector<std::thread> pool;
    std::atomic<int64_t> next_span{w0};
    auto drain = [&]() {
      for (;;) {
        int64_t k = next_span.fetch_add(1);
        if (k >= w1) break;
        size_t sbit = (size_t)(start_byte + k * span_bytes) * 8;
        size_t ebit = (size_t)(start_byte + (k + 1) * span_bytes) * 8;
        if (ebit > nbits) ebit = nbits;
        spec_worker(data, nbits, sbit, ebit, anchor_every, span_bytes,
                    &res[(size_t)(k - w0)]);
      }
    };
    int64_t nw = nworkers < (w1 - w0) ? nworkers : (w1 - w0);
    for (int64_t t = 0; t < nw; t++) pool.emplace_back(drain);
    if (first) {
      // authoritative chain: span 0 scans inline, overlapping the first
      // wave's speculation
      rc = scan_core(br, C, stop0, false, dict_len);
    }
    drain();  // the main thread joins the pool once span 0 is in
    for (auto& t : pool) t.join();
    if (first) {
      first = false;
      if (rc < 0) return rc;
      if (prog) prog->publish(C.ntok);
    }

    for (int64_t k = w0; k < w1 && rc != Z_DONE_; k++) {
      size_t ebit = (size_t)(start_byte + (k + 1) * span_bytes) * 8;
      if (ebit > nbits) ebit = nbits;
      SpecResult& R = res[(size_t)(k - w0)];
      if (br.pos >= ebit) {
        // chain already past this span
      } else if (R.found && R.cand_bit == br.pos) {
        // splice: re-validate the head (speculative dist checks were
        // relaxed — only the first 32 KiB of span output can reach back)
        if (C.ntok + R.ntok > max_toks) return ZE_TOK_CAP;
        if (C.nblk + R.nblk > max_blocks) return ZE_BLK_CAP;
        if (C.nanch + R.nanch > max_anchors) return ZE_ANCH_CAP;
        int64_t rel_out = 0;
        for (int64_t t = 0; t < R.ntok; t++) {
          int32_t d = R.td[(size_t)t];
          if (d) {
            if (rel_out >= 32768) break;
            if ((int64_t)d > C.out + rel_out + dict_len) return ZE_CORRUPT;
            rel_out += R.tv[(size_t)t];
          } else {
            rel_out++;
          }
        }
        memcpy(toks_val + C.ntok, R.tv.get(), (size_t)R.ntok * 4);
        memcpy(toks_dist + C.ntok, R.td.get(), (size_t)R.ntok * 4);
        for (int64_t b = 0; b < R.nblk; b++) {
          BlockRec rec = R.blk[(size_t)b];
          rec.out_start += C.out;
          rec.tok_start += C.ntok;
          blocks[C.nblk + b] = rec;
        }
        for (int64_t a = 0; a < R.nanch; a++) {
          anchor_bit[C.nanch + a] = R.abit[(size_t)a];
          anchor_out[C.nanch + a] = R.aout[(size_t)a] + C.out;
          anchor_block[C.nanch + a] = R.ablk[(size_t)a] + (int32_t)C.nblk;
        }
        C.ntok += R.ntok;
        C.nblk += R.nblk;
        C.nanch += R.nanch;
        C.out += R.out;
        C.crossing |= R.crossing;
        br.pos = R.end_bit;
        rc = R.final_seen ? Z_DONE_ : Z_STOP_;
        spliced++;
      } else {
        // mis-speculation (or no candidate): serial rescan of this span
        rc = scan_core(br, C, ebit, false, dict_len);
        if (rc < 0) return rc;
      }
      R = SpecResult();  // release this span's speculative buffers now
      if (prog) prog->publish(C.ntok);
    }
    w0 = w1;
  }
  if (rc != Z_DONE_) {
    rc = scan_core(br, C, (size_t)-1, false, dict_len);
    if (rc < 0) return rc;
    if (prog) prog->publish(C.ntok);
  }
  *n_toks_out = C.ntok;
  *n_blocks_out = C.nblk;
  *n_anchors_out = C.nanch;
  *end_bit_out = (int64_t)br.pos;
  *out_len_out = C.out;
  *crossing_out = C.crossing;
  *spliced_out = spliced;
  return Z_OK;
}

}  // namespace

int zscan_parallel(const uint8_t* data, int64_t nbytes, int64_t bit_offset,
                   int32_t* toks_val, int32_t* toks_dist, int64_t max_toks,
                   BlockRec* blocks, int64_t max_blocks,
                   int64_t* anchor_bit, int64_t* anchor_out,
                   int32_t* anchor_block,
                   int64_t max_anchors, int64_t anchor_every,
                   int64_t dict_len,
                   int64_t nthreads, int64_t span_bytes,
                   int64_t* n_toks_out, int64_t* n_blocks_out,
                   int64_t* n_anchors_out,
                   int64_t* end_bit_out, int64_t* out_len_out,
                   int64_t* crossing_out, int64_t* spliced_out) {
  return scan_parallel_impl(
      data, nbytes, bit_offset, toks_val, toks_dist, max_toks, blocks,
      max_blocks, anchor_bit, anchor_out, anchor_block, max_anchors,
      anchor_every, dict_len, nthreads, span_bytes, n_toks_out,
      n_blocks_out, n_anchors_out, end_bit_out, out_len_out, crossing_out,
      spliced_out, nullptr);
}

// Fused pipelined decode: the wave-scan runs while a resolver thread
// trails the merge frontier, expanding tokens into ``out`` and folding
// the Adler-32 of the produced bytes into the same cache-hot pass
// (the 32 KiB back-reference window only
// ever points at already-resolved output, so the resolver can trail the
// scan at any distance).  ``out`` may be pre-seeded with ``prefix_len``
// dictionary bytes.  Returns Z_OK, a scan error, Z_ERR_CORRUPT, or -9
// when out_cap is too small (caller grows and retries).
int zdecode_parallel(const uint8_t* data, int64_t nbytes, int64_t bit_offset,
                     int32_t* toks_val, int32_t* toks_dist, int64_t max_toks,
                     BlockRec* blocks, int64_t max_blocks,
                     int64_t* anchor_bit, int64_t* anchor_out,
                     int32_t* anchor_block,
                     int64_t max_anchors, int64_t anchor_every,
                     int64_t dict_len,
                     int64_t nthreads, int64_t span_bytes,
                     uint8_t* out, int64_t out_cap, int64_t prefix_len,
                     int64_t* n_toks_out, int64_t* n_blocks_out,
                     int64_t* n_anchors_out,
                     int64_t* end_bit_out, int64_t* out_len_out,
                     int64_t* crossing_out, int64_t* spliced_out,
                     uint32_t* adler_out) {
  Progress prog;
  std::atomic<int> resolver_rc{0};
  std::thread resolver([&]() {
    int64_t t = 0, o = prefix_len;
    uint32_t s1 = 1, s2 = 0;
    for (;;) {
      int64_t f;
      bool done;
      {
        std::unique_lock<std::mutex> lk(prog.m);
        prog.cv.wait(lk, [&] { return prog.frontier > t || prog.done; });
        f = prog.frontier;
        done = prog.done;
      }
      if (f > t) {
        int rc = resolve_range(toks_val, toks_dist, t, f, out, out_cap,
                               &o, &s1, &s2);
        if (rc) { resolver_rc.store(rc); break; }
        t = f;
      } else if (done) {
        break;
      }
    }
    *adler_out = (s2 << 16) | s1;
  });
  int rc = scan_parallel_impl(
      data, nbytes, bit_offset, toks_val, toks_dist, max_toks, blocks,
      max_blocks, anchor_bit, anchor_out, anchor_block, max_anchors,
      anchor_every, dict_len, nthreads, span_bytes, n_toks_out,
      n_blocks_out, n_anchors_out, end_bit_out, out_len_out, crossing_out,
      spliced_out, &prog);
  prog.finish();
  resolver.join();
  if (rc != Z_OK) return rc;
  int rrc = resolver_rc.load();
  if (rrc) return rrc;
  if (*out_len_out + prefix_len > out_cap) return -9;
  return Z_OK;
}

// Sequential LZ resolve: tokens → output bytes (host fallback path).
// ``out`` may be pre-seeded with ``prefix_len`` bytes of preset dictionary;
// resolution starts after them and ``out_len`` excludes them.
int zresolve(const int32_t* toks_val, const int32_t* toks_dist, int64_t ntok,
             uint8_t* out, int64_t out_cap, int64_t* out_len,
             int64_t prefix_len) {
  int64_t o = prefix_len;
  for (int64_t t = 0; t < ntok; t++) {
    int32_t d = toks_dist[t];
    if (d == 0) {
      if (o >= out_cap) return Z_ERR_TOK_CAP;
      out[o++] = (uint8_t)toks_val[t];
    } else {
      int64_t len = toks_val[t];
      if (d > o || o + len > out_cap) return Z_ERR_CORRUPT;
      const uint8_t* src = out + o - d;
      uint8_t* dst = out + o;
      if (d >= len) {
        memcpy(dst, src, (size_t)len);
      } else {
        // overlapping copy: seed one period, then double the span
        memcpy(dst, src, (size_t)d);
        int64_t done = d;
        while (done < len) {
          int64_t c = done < len - done ? done : len - done;
          memcpy(dst + done, dst, (size_t)c);
          done += c;
        }
      }
      o += len;
    }
  }
  *out_len = o - prefix_len;
  return Z_OK;
}

// Adler-32 (host fallback verification).
uint32_t zadler32(const uint8_t* data, int64_t n) {
  uint32_t s1 = 1, s2 = 0;
  int64_t i = 0;
  while (i < n) {
    int64_t blk = n - i < 5552 ? n - i : 5552;
    for (int64_t k = 0; k < blk; k++) { s1 += data[i + k]; s2 += s1; }
    s1 %= 65521; s2 %= 65521;
    i += blk;
  }
  return (s2 << 16) | s1;
}

}  // extern "C"
