// Native host-side CABAC slice-data serializer for kvazaar_jax.
//
// Role: the sequential entropy-coding finalize stage of the encoder
// (SURVEY.md §2.4 — the reference runs this as a per-frame bitstream job,
// src/encoder_state-bitstream.c:1066).  The device produces dense syntax
// tensors (CU depth / intra modes / quantized levels); this module walks
// the implied quadtree and arithmetic-codes the slice data.  It is a
// performance mirror of kvazaar_jax/bitstream/syntax.py, which remains
// the tested oracle: outputs must be byte-identical.
//
// Build: g++ -O2 -shared -fPIC -o libhevc_cabac.so hevc_cabac.cpp
// ABI: plain C functions at the bottom, driven via ctypes.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

namespace {

// ---------------- CABAC tables (ITU-T H.265 9.3.4) ----------------

const uint8_t kRangeTabLps[64][4] = {
  {128,176,208,240},{128,167,197,227},{128,158,187,216},{123,150,178,205},
  {116,142,169,195},{111,135,160,185},{105,128,152,175},{100,122,144,166},
  {95,116,137,158},{90,110,130,150},{85,104,123,142},{81,99,117,135},
  {77,94,111,128},{73,89,105,122},{69,85,100,116},{66,80,95,110},
  {62,76,90,104},{59,72,86,99},{56,69,81,94},{53,65,77,89},
  {51,62,73,85},{48,59,69,80},{46,56,66,76},{43,53,63,72},
  {41,50,59,69},{39,48,56,65},{37,45,54,62},{35,43,51,59},
  {33,41,48,56},{32,39,46,53},{30,37,43,50},{29,35,41,48},
  {27,33,39,45},{26,31,37,43},{24,30,35,41},{23,28,33,39},
  {22,27,32,37},{21,26,30,35},{20,24,29,33},{19,23,27,31},
  {18,22,26,30},{17,21,25,28},{16,20,23,27},{15,19,22,25},
  {14,18,21,24},{14,17,20,23},{13,16,19,22},{12,15,18,21},
  {12,14,17,20},{11,14,16,19},{11,13,15,18},{10,12,15,17},
  {10,12,14,16},{9,11,13,15},{9,11,12,14},{8,10,12,14},
  {8,9,11,13},{7,9,11,12},{7,9,10,12},{7,8,10,11},
  {6,8,9,11},{6,7,9,10},{6,7,8,9},{2,2,2,2}};

const uint8_t kTransIdxLps[64] = {
  0,0,1,2,2,4,4,5,6,7,8,9,9,11,11,12,13,13,15,15,16,16,18,18,19,19,21,21,
  22,23,23,24,24,25,26,26,27,27,28,29,29,30,30,30,31,32,32,33,33,33,34,34,
  35,35,35,36,36,36,37,37,37,38,38,63};

inline int transIdxMps(int s) { return s < 62 ? s + 1 : 62; }

struct Ctx { uint8_t state, mps; };

void ctx_init(Ctx &c, int init_value, int qp) {
  int slope = (init_value >> 4) * 5 - 45;
  int offset = ((init_value & 15) << 3) - 16;
  if (qp < 0) qp = 0; if (qp > 51) qp = 51;
  int pre = ((slope * qp) >> 4) + offset;
  if (pre < 1) pre = 1; if (pre > 126) pre = 126;
  if (pre <= 63) { c.state = 63 - pre; c.mps = 0; }
  else { c.state = pre - 64; c.mps = 1; }
}

// ---------------- context registry ----------------
// Same layout as bitstream/contexts.py; I-slice init row (slice idx 2).

struct Contexts {
  Ctx sao_merge[1];
  Ctx sao_type[1];
  Ctx split_flag[3];
  Ctx part_size[2];
  Ctx intra_mode[1];
  Ctx chroma_pred_mode[1];
  Ctx cbf_luma[2];
  Ctx cbf_chroma[4];
  Ctx sig_cg[4];
  Ctx sig[42];
  Ctx last_x[18];
  Ctx last_y[18];
  Ctx gt1[24];
  Ctx gt2[6];
  Ctx skip[3];
  Ctx pred_mode[1];
  Ctx merge_flag[1];
  Ctx merge_idx[1];
  Ctx mvd[2];
  Ctx mvp_idx[1];
  Ctx ref_pic[2];
  Ctx cu_qp_delta[2];
  Ctx inter_dir[5];
  Ctx qt_root_cbf[1];
  Ctx tqb[1];

  // slice row: 0 = B, 1 = P, 2 = I (contexts.py INIT_VALUES order).
  void init(int qp, int slice) {
    int s = (slice == 2) ? 2 : (slice == 1 ? 1 : 0);
    static const uint8_t SPLIT[3][3] = {{107,139,126},{107,139,126},{139,141,157}};
    static const uint8_t PART[3][2] = {{154,139},{154,139},{184,154}};
    static const uint8_t IMODE[3][1] = {{183},{154},{184}};
    static const uint8_t CMODE[3][1] = {{152},{152},{63}};
    static const uint8_t CBFL[3][2] = {{153,111},{153,111},{111,141}};
    static const uint8_t CBFC[3][4] = {{149,92,167,154},{149,107,167,154},
                                       {94,138,182,154}};
    static const uint8_t SIGCG[3][4] = {{121,140,61,154},{121,140,61,154},
                                        {91,171,134,141}};
    static const uint8_t SIG[3][42] = {
      {170,154,139,153,139,123,123,63,124,166,183,140,136,153,154,166,
       183,140,136,153,154,166,183,140,136,153,154,170,153,138,138,122,
       121,122,121,167,151,183,140,151,183,140},
      {155,154,139,153,139,123,123,63,153,166,183,140,136,153,154,166,
       183,140,136,153,154,166,183,140,136,153,154,170,153,123,123,107,
       121,107,121,167,151,183,140,151,183,140},
      {111,111,125,110,110,94,124,108,124,107,125,141,179,153,125,107,
       125,141,179,153,125,107,125,141,179,153,125,140,139,182,182,152,
       136,152,136,153,136,139,111,136,139,111}};
    static const uint8_t LAST[3][18] = {
      {125,110,124,110,95,94,125,111,111,79,125,126,111,111,79,108,123,
       93},
      {125,110,94,110,95,79,125,111,110,78,110,111,111,95,94,108,123,
       108},
      {110,110,124,125,140,153,125,127,140,109,111,143,127,111,79,108,
       123,63}};
    static const uint8_t GT1[3][24] = {
      {154,196,167,167,154,152,167,182,182,134,149,136,153,121,136,122,
       169,208,166,167,154,152,167,182},
      {154,196,196,167,154,152,167,182,182,134,149,136,153,121,136,137,
       169,194,166,167,154,167,137,182},
      {140,92,137,138,140,152,138,139,153,74,149,92,139,107,122,152,
       140,179,166,182,140,227,122,197}};
    static const uint8_t GT2[3][6] = {{107,167,91,107,107,167},
                                      {107,167,91,122,107,167},
                                      {138,153,136,167,152,152}};
    static const uint8_t SKIP[3][3] = {{197,185,201},{197,185,201},
                                       {154,154,154}};
    static const uint8_t PRED[3][1] = {{134},{149},{154}};
    static const uint8_t MRGF[3][1] = {{154},{110},{154}};
    static const uint8_t MRGI[3][1] = {{137},{122},{154}};
    static const uint8_t MVD[3][2] = {{169,198},{140,198},{154,154}};
    static const uint8_t MVP[3][1] = {{168},{168},{154}};
    static const uint8_t REFP[3][2] = {{153,153},{153,153},{154,154}};
    static const uint8_t ROOT[3][1] = {{79},{79},{154}};
    static const uint8_t SAOM[3][1] = {{153},{153},{153}};
    static const uint8_t SAOT[3][1] = {{160},{185},{200}};
    static const uint8_t IDIR[3][5] = {{95,79,63,31,31},{95,79,63,31,31},
                                       {154,154,154,154,154}};
    ctx_init(sao_merge[0], SAOM[s][0], qp);
    ctx_init(sao_type[0], SAOT[s][0], qp);
    for (int i = 0; i < 3; i++) ctx_init(split_flag[i], SPLIT[s][i], qp);
    for (int i = 0; i < 2; i++) ctx_init(part_size[i], PART[s][i], qp);
    ctx_init(intra_mode[0], IMODE[s][0], qp);
    ctx_init(chroma_pred_mode[0], CMODE[s][0], qp);
    for (int i = 0; i < 2; i++) ctx_init(cbf_luma[i], CBFL[s][i], qp);
    for (int i = 0; i < 4; i++) ctx_init(cbf_chroma[i], CBFC[s][i], qp);
    for (int i = 0; i < 4; i++) ctx_init(sig_cg[i], SIGCG[s][i], qp);
    for (int i = 0; i < 42; i++) ctx_init(sig[i], SIG[s][i], qp);
    for (int i = 0; i < 18; i++) { ctx_init(last_x[i], LAST[s][i], qp);
                                   ctx_init(last_y[i], LAST[s][i], qp); }
    for (int i = 0; i < 24; i++) ctx_init(gt1[i], GT1[s][i], qp);
    for (int i = 0; i < 6; i++) ctx_init(gt2[i], GT2[s][i], qp);
    for (int i = 0; i < 3; i++) ctx_init(skip[i], SKIP[s][i], qp);
    ctx_init(pred_mode[0], PRED[s][0], qp);
    ctx_init(merge_flag[0], MRGF[s][0], qp);
    ctx_init(merge_idx[0], MRGI[s][0], qp);
    for (int i = 0; i < 2; i++) ctx_init(mvd[i], MVD[s][i], qp);
    ctx_init(mvp_idx[0], MVP[s][0], qp);
    for (int i = 0; i < 2; i++) ctx_init(ref_pic[i], REFP[s][i], qp);
    for (int i = 0; i < 2; i++) ctx_init(cu_qp_delta[i], 154, qp);
    for (int i = 0; i < 5; i++) ctx_init(inter_dir[i], IDIR[s][i], qp);
    ctx_init(qt_root_cbf[0], ROOT[s][0], qp);
    ctx_init(tqb[0], 154, qp);
  }
};

// ---------------- bit + arithmetic writer ----------------

// Spec-form M-coder (9.3.4.3 formulation: low/range with outstanding-
// bit carry deferral), engineered for throughput on the hot path: bits
// accumulate MSB-first in a 64-bit register flushed four bytes at a
// time, and all hot calls are inlined.  Byte-identical to the Python
// oracle (tests/test_native_cabac.py) and to the previous per-bit
// writer.
struct CabacEnc {
  std::vector<uint8_t> bytes;
  uint64_t acc = 0; int acc_n = 0;          // bit accumulator, MSB first
  uint32_t low = 0, range = 510;
  int outstanding = 0; bool first = true;

  CabacEnc() { bytes.reserve(1 << 16); }

  inline void append_bits(uint64_t v, int n) {  // n <= 32
    acc = (acc << n) | v;
    acc_n += n;
    if (acc_n >= 32) {
      acc_n -= 32;
      uint32_t w = __builtin_bswap32((uint32_t)(acc >> acc_n));
      size_t sz = bytes.size();
      bytes.resize(sz + 4);
      std::memcpy(&bytes[sz], &w, 4);
    }
  }
  inline void raw_bit(int b) { append_bits((uint64_t)(b & 1), 1); }
  inline void put_bit(int b) {
    if (__builtin_expect(first, 0)) first = false;
    else append_bits((uint64_t)b, 1);
    if (__builtin_expect(outstanding > 0, 0)) {
      while (outstanding > 0) {
        int k = outstanding > 24 ? 24 : outstanding;
        append_bits(b ? 0 : ((1ull << k) - 1), k);
        outstanding -= k;
      }
    }
  }
  inline void renorm() {
    while (range < 256) {
      if (low >= 512) { put_bit(1); low -= 512; }
      else if (low < 256) put_bit(0);
      else { low -= 256; outstanding++; }
      range <<= 1; low <<= 1;
    }
  }
  inline void bin(Ctx &c, int v) {
    uint32_t lps = kRangeTabLps[c.state][(range >> 6) & 3];
    range -= lps;
    if (v != c.mps) {
      low += range; range = lps;
      if (c.state == 0) c.mps ^= 1;
      c.state = kTransIdxLps[c.state];
    } else {
      c.state = transIdxMps(c.state);
      if (range >= 256) return;
    }
    renorm();
  }
  inline void bypass(int v) {
    low <<= 1;
    if (v) low += range;
    if (low >= 1024) { put_bit(1); low -= 1024; }
    else if (low < 512) put_bit(0);
    else { low -= 512; outstanding++; }
  }
  inline void bypass_bins(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; i--) bypass((v >> i) & 1);
  }
  // Unary run of n one-bits followed by a zero (go-rice prefixes):
  // identical output to n+1 bypass() calls.
  inline void bypass_ones_then_zero(int n) {
    for (int i = 0; i < n; i++) bypass(1);
    bypass(0);
  }
  void terminate(int v) {
    range -= 2;
    if (v) { low += range; range = 2; renorm(); flush(); }
    else renorm();
  }
  void flush() {
    put_bit((low >> 9) & 1);
    raw_bit((low >> 8) & 1);
    raw_bit(1);
  }
  void align_zero() {
    while (acc_n & 7) raw_bit(0);
    while (acc_n >= 8) {
      acc_n -= 8;
      bytes.push_back((uint8_t)(acc >> acc_n));
    }
  }
};

// ---------------- scan tables ----------------

struct Scans {
  // [log2-2][scanIdx][pos] -> (x,y) packed, plus subblock scans.
  std::vector<uint16_t> coeff[4][3];
  std::vector<uint16_t> sub[4][3];

  static void scan_grid(int size, int scan_idx,
                        std::vector<uint16_t> &out) {
    out.clear();
    if (scan_idx == 1) {            // horizontal
      for (int y = 0; y < size; y++)
        for (int x = 0; x < size; x++) out.push_back((y << 8) | x);
    } else if (scan_idx == 2) {     // vertical
      for (int x = 0; x < size; x++)
        for (int y = 0; y < size; y++) out.push_back((y << 8) | x);
    } else {                        // up-right diagonal
      for (int d = 0; d < 2 * size - 1; d++) {
        int y = d < size ? d : size - 1;
        int x = d - y;
        while (y >= 0 && x < size) { out.push_back((y << 8) | x);
                                     x++; y--; }
      }
    }
  }

  Scans() {
    for (int l = 2; l <= 5; l++) {
      int size = 1 << l;
      for (int s = 0; s < 3; s++) {
        std::vector<uint16_t> inner, subg;
        scan_grid(4, s, inner);
        if (size == 4) {
          coeff[l - 2][s] = inner;
          scan_grid(1, s, sub[l - 2][s]);
        } else {
          scan_grid(size / 4, s, subg);
          sub[l - 2][s] = subg;
          auto &c = coeff[l - 2][s];
          for (auto sb : subg) {
            int sx = (sb & 255) * 4, sy = (sb >> 8) * 4;
            for (auto p : inner)
              c.push_back(((sy + (p >> 8)) << 8) | (sx + (p & 255)));
          }
        }
      }
    }
  }
};

const Scans g_scans;

int intra_scan_idx(int mode, int log2_size, bool is_chroma) {
  if (log2_size == 2 || (log2_size == 3 && !is_chroma)) {
    if (mode >= 6 && mode <= 14) return 2;
    if (mode >= 22 && mode <= 30) return 1;
  }
  return 0;
}

const uint8_t kCtxIdxMap4x4[16] = {0,1,4,5,2,3,4,5,6,6,8,8,7,7,8,8};

int sig_ctx(int xc, int yc, int log2_size, int scan_idx, bool chroma,
            int csbf_right, int csbf_below) {
  int s;
  if (log2_size == 2) s = kCtxIdxMap4x4[(yc << 2) + xc];
  else if (xc + yc == 0) s = 0;
  else {
    int xb = xc & 3, yb = yc & 3;
    int prev = csbf_right + 2 * csbf_below;
    if (prev == 0) s = (xb + yb == 0) ? 2 : (xb + yb < 3 ? 1 : 0);
    else if (prev == 1) s = (yb == 0) ? 2 : (yb == 1 ? 1 : 0);
    else if (prev == 2) s = (xb == 0) ? 2 : (xb == 1 ? 1 : 0);
    else s = 2;
    if (!chroma && ((xc >> 2) || (yc >> 2))) s += 3;
    if (log2_size == 3) s += chroma ? 9 : (scan_idx == 0 ? 9 : 15);
    else s += chroma ? 12 : 21;
  }
  return s + (chroma ? 27 : 0);
}

int last_prefix(int v) {
  if (v < 4) return v;
  int bl = 32 - __builtin_clz((unsigned)v);  // bit_length
  return ((v >> (bl - 2)) & 1) + ((bl - 2) << 1) + 2;
}

// Precomputed sig_coeff_flag contexts: the per-coefficient ctx depends
// only on (TB size, scanIdx, chroma, CG==origin, neighbor-CSBF pattern,
// position-in-CG) — bake sig_ctx() into a table once so the hottest
// loop in the serializer is a single lookup per coefficient.
// [log2-2][scanIdx][chroma][cg-class(0=origin CG)][pattern][pos]
static uint8_t g_sigtbl[4][3][2][2][4][16];

static void init_sigtbl() {
  for (int l = 2; l <= 5; l++)
    for (int sidx = 0; sidx < 3; sidx++)
      for (int ch = 0; ch < 2; ch++)
        for (int cls = 0; cls < 2; cls++)
          for (int pat = 0; pat < 4; pat++)
            for (int n = 0; n < 16; n++) {
              uint16_t p4 = g_scans.coeff[0][sidx][n];
              int xb = p4 & 255, yb = p4 >> 8;
              // Any non-origin CG sees the same rules (the +3 luma
              // offset and the DC special-case are CG-class-wide).
              int xc = xb + (cls ? 4 : 0), yc = yb + (cls ? 4 : 0);
              g_sigtbl[l - 2][sidx][ch][cls][pat][n] = (uint8_t)
                  sig_ctx(xc, yc, l, sidx, ch != 0, pat & 1,
                          (pat >> 1) & 1);
            }
}

struct SigTblInit { SigTblInit() { init_sigtbl(); } };
static SigTblInit g_sigtbl_init_once;

// ---------------- frame serializer ----------------

struct FrameParams {
  int width, height;       // coded luma size
  int chroma;              // 0 or 1 (4:2:0)
  int qp;
  int log2_ctu, log2_min_cu, log2_max_tu;
  const uint8_t *depth8;   // (h/8, w/8)
  const uint8_t *mode4;    // (h/4, w/4)
  const int32_t *coeff_y;  // (h, w)
  const int32_t *coeff_cb; // (h/2, w/2)
  const int32_t *coeff_cr;
  int slice_type = 2;      // 2 = I, 1 = P
  int transquant_bypass = 0;
  int sign_hiding = 0;
  const uint8_t *inter8 = nullptr;   // (h/8, w/8)
  const uint8_t *skip8 = nullptr;
  const int8_t *merge8 = nullptr;    // merge_idx or -1
  const uint8_t *mvp8 = nullptr;
  const int32_t *mvd8 = nullptr;     // (h/8, w/8, 2)
  // B slices: prediction direction (0 L0 / 1 L1 / 2 BI) + list-1
  // motion (list 0 reuses the fields above).
  const uint8_t *dir8 = nullptr;
  const uint8_t *mvp8_l1 = nullptr;
  const int32_t *mvd8_l1 = nullptr;
  const uint8_t *ref8 = nullptr;     // L0 ref_idx per cell
  int nref_l0 = 1;
  const uint8_t *part8 = nullptr;    // PartMode at CU marker cells
  int amp = 0;                       // amp_enabled (binarization)
  // Explicit chroma prediction mode per 8x8 cell (--rd 3); 255 or
  // null = DM (chroma shares the luma mode).
  const uint8_t *cmode4 = nullptr;   // (h/8, w/8)
  int32_t *qp_ctu = nullptr;         // (Cy, Cx) per-CTU QP (in/out)
  int dqp = 0;                       // cu_qp_delta_enabled
  // SAO per CTU, 20 int8 each: [merge, type_l, type_c, eo_l, eo_c,
  // bp_y, bp_cb, bp_cr, off_y[4], off_cb[4], off_cr[4]] (offsets
  // signed as applied); nullptr = SAO disabled.
  const int8_t *sao = nullptr;
};

struct Serializer {
  const FrameParams &p;
  Contexts ctx;
  CabacEnc c;

  // cu_qp_delta predictor chain (QG = CTU, 8.6.1).
  int qp_pred_ = 0; int qg_qp_ = 0; bool qg_coded_ = false;
  int qg_cy_ = 0, qg_cx_ = 0;

  explicit Serializer(const FrameParams &fp) : p(fp) {
    ctx.init(p.qp, p.slice_type);
    qp_pred_ = p.qp;
  }

  void qg_reset() { if (p.dqp) qp_pred_ = p.qp; }
  void qg_start(int cxi, int cyi) {
    if (!p.dqp) return;
    qg_cy_ = cyi; qg_cx_ = cxi; qg_coded_ = false;
    int cw = (p.width + 63) >> 6;
    qg_qp_ = p.qp_ctu[(size_t)cyi * cw + cxi];
  }
  void qg_end() {
    if (!p.dqp) return;
    int eff = qg_coded_ ? qg_qp_ : qp_pred_;
    int cw = (p.width + 63) >> 6;
    p.qp_ctu[(size_t)qg_cy_ * cw + qg_cx_] = eff;
    qp_pred_ = eff;
  }
  // cu_qp_delta_abs/sign at the first TU with coded coefficients
  // (7.3.8.10; TR cMax 5 + EG0, 9.3.3.1.3).
  void maybe_dqp(int any_cbf) {
    if (!p.dqp || qg_coded_ || !any_cbf) return;
    int delta = qg_qp_ - qp_pred_;
    int a = delta < 0 ? -delta : delta;
    int prefix = a < 5 ? a : 5;
    c.bin(ctx.cu_qp_delta[0], prefix ? 1 : 0);
    if (prefix) {
      for (int k = 1; k < prefix; k++) c.bin(ctx.cu_qp_delta[1], 1);
      if (prefix < 5) c.bin(ctx.cu_qp_delta[1], 0);
      else egk(a - 5, 0);
    }
    if (a) c.bypass(delta < 0 ? 1 : 0);
    qg_coded_ = true;
  }

  bool is_inter_cu(int x, int y) const {
    return p.inter8 && p.inter8[(y >> 3) * (p.width >> 3) + (x >> 3)];
  }
  int cell8(int x, int y) const {
    return (y >> 3) * (p.width >> 3) + (x >> 3);
  }

  int depth_at(int x, int y) const {
    return p.depth8[(y >> 3) * (p.width >> 3) + (x >> 3)];
  }
  int mode_at(int x, int y) const {
    return p.mode4[(y >> 2) * (p.width >> 2) + (x >> 2)];
  }
  // Effective chroma prediction mode of the CU covering luma (x, y):
  // cmode4 when explicit (--rd 3), else DM (8.4.3).
  int chroma_mode_at(int x, int y) const {
    if (p.cmode4) {
      int cm = p.cmode4[(y >> 3) * (p.width >> 3) + (x >> 3)];
      if (cm != 255) return cm;
    }
    return mode_at(x, y);
  }
  const int32_t *plane(int cidx, int &stride) const {
    if (cidx == 0) { stride = p.width; return p.coeff_y; }
    stride = p.width >> 1;
    return cidx == 1 ? p.coeff_cb : p.coeff_cr;
  }

  void mpm_for(int x0, int y0, int mpm[3]) const {
    int ctu = 1 << p.log2_ctu;
    int cl = 1, ca = 1;  // DC default (also for non-intra neighbors)
    if (x0 > 0 && !is_inter_cu(x0 - 1, y0)) cl = mode_at(x0 - 1, y0);
    if (y0 > 0 && (y0 % ctu) != 0 && !is_inter_cu(x0, y0 - 1))
      ca = mode_at(x0, y0 - 1);
    if (cl == ca) {
      if (cl < 2) { mpm[0] = 0; mpm[1] = 1; mpm[2] = 26; }
      else { mpm[0] = cl; mpm[1] = 2 + ((cl + 29) % 32);
             mpm[2] = 2 + ((cl - 1) % 32); }
    } else {
      mpm[0] = cl; mpm[1] = ca;
      if (cl != 0 && ca != 0) mpm[2] = 0;
      else if (cl != 1 && ca != 1) mpm[2] = 1;
      else mpm[2] = 26;
    }
  }

  // sao() per CTU (7.3.8.3), interleaved before the coding quadtree.
  void emit_sao(int cxi, int cyi, int ctus_x) {
    if (!p.sao) return;
    const int8_t *e = p.sao + (size_t)(cyi * ctus_x + cxi) * 20;
    int merge = e[0];
    if (cxi > 0) c.bin(ctx.sao_merge[0], merge == 1 ? 1 : 0);
    if (merge != 1 && cyi > 0)
      c.bin(ctx.sao_merge[0], merge == 2 ? 1 : 0);
    if (merge) return;
    int ncomp = p.chroma ? 3 : 1;
    for (int ci = 0; ci < ncomp; ci++) {
      int t = ci == 0 ? e[1] : e[2];
      if (ci < 2) {
        c.bin(ctx.sao_type[0], t ? 1 : 0);
        if (t) c.bypass(t == 2 ? 1 : 0);
      }
      if (!t) continue;
      const int8_t *off = e + 8 + ci * 4;
      for (int i = 0; i < 4; i++) {
        int a = off[i] < 0 ? -off[i] : off[i];
        for (int j = 0; j < a; j++) c.bypass(1);
        if (a < 7) c.bypass(0);
      }
      if (t == 1) {
        for (int i = 0; i < 4; i++)
          if (off[i]) c.bypass(off[i] < 0 ? 1 : 0);
        c.bypass_bins((uint32_t)(uint8_t)e[5 + ci], 5);
      } else if (ci != 2) {
        c.bypass_bins((uint32_t)(uint8_t)e[ci == 0 ? 3 : 4], 2);
      }
    }
  }

  void encode_slice() {
    int ctu = 1 << p.log2_ctu;
    int cx = (p.width + ctu - 1) >> p.log2_ctu;
    int cy = (p.height + ctu - 1) >> p.log2_ctu;
    int n = cx * cy;
    qg_reset();
    for (int i = 0; i < n; i++) {
      emit_sao(i % cx, i / cx, cx);
      qg_start(i % cx, i / cx);
      quadtree((i % cx) << p.log2_ctu, (i / cx) << p.log2_ctu,
               p.log2_ctu, 0);
      qg_end();
      c.terminate(i == n - 1 ? 1 : 0);
    }
    c.align_zero();
  }

  // WPP: one CABAC substream per CTU row; contexts inherited from the
  // row above after its 2nd CTU (9.3.2.3).  Substream bytes appended to
  // `out`; per-row byte sizes into `sizes`.
  void encode_slice_wpp(std::vector<uint8_t> &out,
                        std::vector<int64_t> &sizes) {
    int ctu = 1 << p.log2_ctu;
    int ctus_x = (p.width + ctu - 1) >> p.log2_ctu;
    int ctus_y = (p.height + ctu - 1) >> p.log2_ctu;
    Contexts saved;
    bool have_saved = false;
    for (int row = 0; row < ctus_y; row++) {
      if (row > 0) {
        if (have_saved) ctx = saved;
        else ctx.init(p.qp, p.slice_type);
        c = CabacEnc();
      }
      qg_reset();
      for (int cxi = 0; cxi < ctus_x; cxi++) {
        emit_sao(cxi, row, ctus_x);
        qg_start(cxi, row);
        quadtree(cxi << p.log2_ctu, row << p.log2_ctu, p.log2_ctu, 0);
        qg_end();
        bool last = (row == ctus_y - 1) && (cxi == ctus_x - 1);
        c.terminate(last ? 1 : 0);
        if (cxi == 1) { saved = ctx; have_saved = true; }
        if (cxi == ctus_x - 1 && !last) c.terminate(1);
      }
      c.align_zero();
      sizes.push_back((int64_t)c.bytes.size());
      out.insert(out.end(), c.bytes.begin(), c.bytes.end());
    }
  }

  // One WPP row into this serializer's CabacEnc (contexts must be
  // pre-seeded by the caller).  Publishes the post-2nd-CTU context
  // snapshot for the next row (the 2-CTU-lag inheritance the
  // reference schedules with threadqueue deps, encoderstate.c:711).
  void encode_wpp_row(int row, int ctus_x, int ctus_y,
                      Contexts *snap, std::atomic<int> *snap_ready) {
    qg_reset();
    for (int cxi = 0; cxi < ctus_x; cxi++) {
      emit_sao(cxi, row, ctus_x);
      qg_start(cxi, row);
      quadtree(cxi << p.log2_ctu, row << p.log2_ctu, p.log2_ctu, 0);
      qg_end();
      bool last = (row == ctus_y - 1) && (cxi == ctus_x - 1);
      c.terminate(last ? 1 : 0);
      if (cxi == 1 && snap) {
        *snap = ctx;
        snap_ready->store(1, std::memory_order_release);
      }
      if (cxi == ctus_x - 1 && !last) c.terminate(1);
    }
    c.align_zero();
  }

  void quadtree(int x0, int y0, int log2_size, int depth) {
    int size = 1 << log2_size;
    bool inside = x0 + size <= p.width && y0 + size <= p.height;
    bool split = depth_at(x0, y0) > depth;
    if (inside && log2_size > p.log2_min_cu) {
      int inc = 0;
      if (x0 > 0 && depth_at(x0 - 1, y0) > depth) inc++;
      if (y0 > 0 && depth_at(x0, y0 - 1) > depth) inc++;
      c.bin(ctx.split_flag[inc], split ? 1 : 0);
    } else if (log2_size > p.log2_min_cu) {
      split = true;
    }
    if (split) {
      int half = size >> 1;
      for (int dy = 0; dy <= half; dy += half ? half : 1) {
        for (int dx = 0; dx <= half; dx += half ? half : 1) {
          int x1 = x0 + dx, y1 = y0 + dy;
          if (x1 < p.width && y1 < p.height)
            quadtree(x1, y1, log2_size - 1, depth + 1);
          if (!half) break;
        }
        if (!half) break;
      }
    } else {
      coding_unit(x0, y0, log2_size);
    }
  }

  void egk(int value, int k) {
    while (value >= (1 << k)) { c.bypass(1); value -= 1 << k; k++; }
    c.bypass(0);
    if (k) c.bypass_bins((uint32_t)value, k);
  }

  // One PU's motion syntax at its marker cell (P slices).
  void pu_motion(int cell) {
    int midx = p.merge8[cell];
    if (midx >= 0) {
      c.bin(ctx.merge_flag[0], 1);
      write_merge_idx(midx);
      return;
    }
    c.bin(ctx.merge_flag[0], 0);
    if (p.nref_l0 > 1)
      write_ref_idx(p.ref8 ? p.ref8[cell] : 0, p.nref_l0);
    write_mvd(p.mvd8 + cell * 2);
    c.bin(ctx.mvp_idx[0], p.mvp8[cell]);
  }

  // ref_idx_lX: TR cMax = nref-1 (9.3.3, Table 9-42): bin0 ctx0,
  // bin1 ctx1, rest bypass.
  void write_ref_idx(int idx, int nref) {
    c.bin(ctx.ref_pic[0], idx ? 1 : 0);
    if (!idx) return;
    for (int i = 0; i < nref - 2; i++) {
      int sym = (i == idx - 1) ? 0 : 1;
      if (i == 0) c.bin(ctx.ref_pic[1], sym); else c.bypass(sym);
      if (!sym) break;
    }
  }

  void write_merge_idx(int idx) {
    c.bin(ctx.merge_idx[0], idx ? 1 : 0);
    if (idx) {
      for (int k = 1; k < idx; k++) c.bypass(1);
      if (idx < 4) c.bypass(0);
    }
  }

  void write_mvd(const int32_t *mvd) {
    int ax = mvd[0] < 0 ? -mvd[0] : mvd[0];
    int ay = mvd[1] < 0 ? -mvd[1] : mvd[1];
    c.bin(ctx.mvd[0], ax ? 1 : 0);
    c.bin(ctx.mvd[0], ay ? 1 : 0);
    if (ax) c.bin(ctx.mvd[1], ax > 1 ? 1 : 0);
    if (ay) c.bin(ctx.mvd[1], ay > 1 ? 1 : 0);
    if (ax) { if (ax > 1) egk(ax - 2, 1); c.bypass(mvd[0] < 0); }
    if (ay) { if (ay > 1) egk(ay - 2, 1); c.bypass(mvd[1] < 0); }
  }

  int root_cbf(int x0, int y0, int log2_size) const {
    if (tu_cbf(0, x0, y0, log2_size)) return 1;
    if (p.chroma && (tu_cbf(1, x0, y0, log2_size)
                     || tu_cbf(2, x0, y0, log2_size))) return 1;
    return 0;
  }

  void coding_unit(int x0, int y0, int log2_size) {
    if (p.transquant_bypass) c.bin(ctx.tqb[0], 1);
    if (p.slice_type != 2) {
      int cell = cell8(x0, y0);
      int skipv = p.skip8[cell];
      int inc = 0;
      if (x0 > 0 && p.skip8[cell8(x0 - 1, y0)]) inc++;
      if (y0 > 0 && p.skip8[cell8(x0, y0 - 1)]) inc++;
      c.bin(ctx.skip[inc], skipv);
      if (skipv) { write_merge_idx(p.merge8[cell]); return; }
      int inter = p.inter8[cell];
      c.bin(ctx.pred_mode[0], inter ? 0 : 1);
      if (inter) {
        int part = p.part8 ? p.part8[cell] : 0;
        c.bin(ctx.part_size[0], part == 0 ? 1 : 0);
        if (part) {
          // Table 9-34 (NxN disallowed): bin1 horiz/vert; with AMP a
          // bypass bin selects symmetric and another picks nU/nD,
          // nL/nR.
          int horiz = (part == 1 || part == 4 || part == 5);
          c.bin(ctx.part_size[1], horiz ? 1 : 0);
          if (p.amp) {
            int sym = (part == 1 || part == 2);
            c.bypass(sym ? 1 : 0);
            if (!sym) c.bypass((part == 5 || part == 7) ? 1 : 0);
          }
          int cells = 1 << (log2_size - 3);
          int h = cells >> 1, qq = cells >= 4 ? (cells >> 2) : 1;
          int oy1 = 0, ox1 = 0;
          switch (part) {
            case 1: oy1 = h; break;
            case 2: ox1 = h; break;
            case 4: oy1 = qq; break;
            case 5: oy1 = cells - qq; break;
            case 6: ox1 = qq; break;
            case 7: ox1 = cells - qq; break;
          }
          int cw8 = p.width >> 3;
          int cy8 = y0 >> 3, cx8 = x0 >> 3;
          pu_motion(cy8 * cw8 + cx8);
          pu_motion((cy8 + oy1) * cw8 + (cx8 + ox1));
          // rqt_root_cbf always coded for non-2Nx2N inter (7.3.8.5).
          int root = root_cbf(x0, y0, log2_size);
          c.bin(ctx.qt_root_cbf[0], root);
          if (root) transform_tree(x0, y0, log2_size, 0);
          return;
        }
        int midx = p.merge8[cell];
        if (midx >= 0) {
          c.bin(ctx.merge_flag[0], 1);
          write_merge_idx(midx);
        } else {
          c.bin(ctx.merge_flag[0], 0);
          if (p.slice_type == 0) {            // B: inter_pred_idc
            int d = p.dir8[cell];
            int depth = p.depth8[cell];
            c.bin(ctx.inter_dir[depth], d == 2 ? 1 : 0);
            if (d != 2) c.bin(ctx.inter_dir[4], d == 1 ? 1 : 0);
            if (d != 1) {
              write_mvd(p.mvd8 + cell * 2);
              c.bin(ctx.mvp_idx[0], p.mvp8[cell]);
            }
            if (d != 0) {
              write_mvd(p.mvd8_l1 + cell * 2);
              c.bin(ctx.mvp_idx[0], p.mvp8_l1[cell]);
            }
          } else {
            if (p.nref_l0 > 1)
              write_ref_idx(p.ref8 ? p.ref8[cell] : 0, p.nref_l0);
            write_mvd(p.mvd8 + cell * 2);
            c.bin(ctx.mvp_idx[0], p.mvp8[cell]);
          }
        }
        int root = root_cbf(x0, y0, log2_size);
        if (midx < 0) c.bin(ctx.qt_root_cbf[0], root);
        if (root) transform_tree(x0, y0, log2_size, 0);
        return;
      }
    }
    if (log2_size == p.log2_min_cu) c.bin(ctx.part_size[0], 1);
    int mode = mode_at(x0, y0);
    int mpm[3]; mpm_for(x0, y0, mpm);
    int idx = mode == mpm[0] ? 0 : mode == mpm[1] ? 1 :
              mode == mpm[2] ? 2 : -1;
    if (idx >= 0) {
      c.bin(ctx.intra_mode[0], 1);
      c.bypass(idx ? 1 : 0);
      if (idx) c.bypass(idx - 1);
    } else {
      c.bin(ctx.intra_mode[0], 0);
      int sorted[3] = {mpm[0], mpm[1], mpm[2]};
      if (sorted[0] > sorted[1]) std::swap(sorted[0], sorted[1]);
      if (sorted[1] > sorted[2]) std::swap(sorted[1], sorted[2]);
      if (sorted[0] > sorted[1]) std::swap(sorted[0], sorted[1]);
      int rem = mode;
      for (int i = 2; i >= 0; i--) if (rem > sorted[i]) rem--;
      c.bypass_bins((uint32_t)rem, 5);
    }
    if (p.chroma) {
      // intra_chroma_pred_mode (9.3.3.8): DM = ctx bin 0; explicit =
      // ctx bin 1 + 2-bit FL index into the Table 8-3 list (the
      // luma-dup entry replaced by angular-34).
      int cm = chroma_mode_at(x0, y0);
      if (cm == mode) {
        c.bin(ctx.chroma_pred_mode[0], 0);
      } else {
        static const int base[4] = {0, 26, 10, 1};
        int idx = -1;
        for (int i = 0; i < 4; i++) {
          int cand = base[i] == mode ? 34 : base[i];
          if (cand == cm) { idx = i; break; }
        }
        c.bin(ctx.chroma_pred_mode[0], 1);
        c.bypass((idx >> 1) & 1);
        c.bypass(idx & 1);
      }
    }
    transform_tree(x0, y0, log2_size, 0);
  }

  // Per-4x4-cell nonzero bitmaps: tu_cbf queries repeat per TU (root
  // cbf + tree cbfs) and would otherwise full-scan every ZERO block —
  // the common case in P frames.  Built once per plane; the
  // row-parallel WPP drive shares ONE set across workers.
  mutable std::vector<uint8_t> nz4_[3];
  const std::vector<uint8_t> *shared_nz_ = nullptr;   // [3]

  void build_nz4(int cidx, std::vector<uint8_t> &m) const {
    int stride; const int32_t *pl = plane(cidx, stride);
    int shift = cidx ? 1 : 0;
    int ph = p.height >> shift, pw = p.width >> shift;
    int cw = pw >> 2;
    m.assign((size_t)(ph >> 2) * cw, 0);
    for (int cy = 0; cy < (ph >> 2); cy++)
      for (int cx = 0; cx < cw; cx++) {
        const int32_t *b = pl + (size_t)(cy * 4) * stride + cx * 4;
        uint8_t any = 0;
        for (int j = 0; j < 4 && !any; j++)
          for (int i = 0; i < 4; i++)
            if (b[j * stride + i]) { any = 1; break; }
        m[(size_t)cy * cw + cx] = any;
      }
  }

  const uint8_t *nz4(int cidx, int &cells_w) const {
    int shift = cidx ? 1 : 0;
    cells_w = (p.width >> shift) >> 2;
    if (shared_nz_) return shared_nz_[cidx].data();
    if (nz4_[cidx].empty()) build_nz4(cidx, nz4_[cidx]);
    return nz4_[cidx].data();
  }

  int tu_cbf(int cidx, int x0, int y0, int log2_size) const {
    int shift = cidx ? 1 : 0;
    int n = 1 << (log2_size - shift - 2);   // cells per side
    int cw; const uint8_t *m = nz4(cidx, cw);
    int cx = x0 >> (shift + 2), cy = y0 >> (shift + 2);
    for (int j = 0; j < n; j++)
      for (int i = 0; i < n; i++)
        if (m[(size_t)(cy + j) * cw + cx + i]) return 1;
    return 0;
  }

  void transform_tree(int x0, int y0, int log2_size, int tr_depth) {
    bool split = log2_size > p.log2_max_tu;
    int cbf_cb = 0, cbf_cr = 0;
    if (p.chroma && log2_size > 2) {
      cbf_cb = tu_cbf(1, x0, y0, log2_size);
      cbf_cr = tu_cbf(2, x0, y0, log2_size);
      c.bin(ctx.cbf_chroma[tr_depth], cbf_cb);
      c.bin(ctx.cbf_chroma[tr_depth], cbf_cr);
    }
    if (split) {
      int half = 1 << (log2_size - 1);
      for (int dy = 0; dy <= half; dy += half)
        for (int dx = 0; dx <= half; dx += half)
          leaf_or_split(x0 + dx, y0 + dy, log2_size - 1, tr_depth + 1,
                        cbf_cb, cbf_cr);
    } else {
      int cbf_luma = tu_cbf(0, x0, y0, log2_size);
      if (!is_inter_cu(x0, y0) || tr_depth != 0 || cbf_cb || cbf_cr)
        c.bin(ctx.cbf_luma[tr_depth == 0 ? 1 : 0], cbf_luma);
      transform_unit(x0, y0, log2_size, cbf_luma, cbf_cb, cbf_cr);
    }
  }

  void leaf_or_split(int x0, int y0, int log2_size, int tr_depth,
                     int parent_cb, int parent_cr) {
    int cbf_cb = 0, cbf_cr = 0;
    if (p.chroma && log2_size > 2) {
      if (parent_cb) { cbf_cb = tu_cbf(1, x0, y0, log2_size);
                       c.bin(ctx.cbf_chroma[tr_depth], cbf_cb); }
      if (parent_cr) { cbf_cr = tu_cbf(2, x0, y0, log2_size);
                       c.bin(ctx.cbf_chroma[tr_depth], cbf_cr); }
    }
    int cbf_luma = tu_cbf(0, x0, y0, log2_size);
    c.bin(ctx.cbf_luma[tr_depth == 0 ? 1 : 0], cbf_luma);
    transform_unit(x0, y0, log2_size, cbf_luma, cbf_cb, cbf_cr);
  }

  void transform_unit(int x0, int y0, int log2_size, int cbf_luma,
                      int cbf_cb, int cbf_cr) {
    maybe_dqp(cbf_luma || cbf_cb || cbf_cr);
    if (cbf_luma) residual(x0, y0, log2_size, 0);
    if (p.chroma && log2_size > 2) {
      if (cbf_cb) residual(x0 >> 1, y0 >> 1, log2_size - 1, 1);
      if (cbf_cr) residual(x0 >> 1, y0 >> 1, log2_size - 1, 2);
    }
  }

  void encode_last_xy(int lx, int ly, int log2_size, bool chroma) {
    int off, shift;
    if (chroma) { off = 15; shift = log2_size - 2; }
    else { off = 3 * (log2_size - 2) + ((log2_size - 1) >> 2);
           shift = (log2_size + 1) >> 2; }
    int cmax = (log2_size << 1) - 1;
    int vals[2] = {lx, ly};
    Ctx *arrs[2] = {ctx.last_x, ctx.last_y};
    for (int k = 0; k < 2; k++) {
      int prefix = last_prefix(vals[k]);
      int b = 0;
      for (; b < prefix && b < cmax; b++)
        c.bin(arrs[k][off + (b >> shift)], 1);
      if (prefix < cmax) c.bin(arrs[k][off + (prefix >> shift)], 0);
    }
    for (int k = 0; k < 2; k++) {
      int prefix = last_prefix(vals[k]);
      if (prefix > 3) {
        int nbits = (prefix >> 1) - 1;
        int suffix = vals[k] - ((2 + (prefix & 1)) << nbits);
        c.bypass_bins((uint32_t)suffix, nbits);
      }
    }
  }

  void encode_remaining(int value, int rice) {
    if ((value >> rice) < 3) {
      int q = value >> rice;
      for (int i = 0; i < q; i++) c.bypass(1);
      c.bypass(0);
      if (rice) c.bypass_bins((uint32_t)(value & ((1 << rice) - 1)),
                              rice);
    } else {
      int v = value - (3 << rice);
      int length = rice;
      while (v >= (1 << length)) { v -= 1 << length; length++; }
      for (int i = 0; i < 3 + length - rice; i++) c.bypass(1);
      c.bypass(0);
      if (length) c.bypass_bins((uint32_t)v, length);
    }
  }

  void residual(int x0, int y0, int log2_size, int cidx) {
    int size = 1 << log2_size;
    bool chroma = cidx > 0;
    int stride; const int32_t *pl = plane(cidx, stride);
    int lx0 = chroma ? x0 * 2 : x0;
    int ly0 = chroma ? y0 * 2 : y0;
    int scan_idx;
    if (is_inter_cu(lx0, ly0)) {
      scan_idx = 0;                     // inter: always diagonal
    } else {
      int mode = chroma ? chroma_mode_at(lx0, ly0)
                        : mode_at(lx0, ly0);
      scan_idx = intra_scan_idx(mode, log2_size, chroma);
    }
    const auto &scan = g_scans.coeff[log2_size - 2][scan_idx];
    const auto &sbscan = g_scans.sub[log2_size - 2][scan_idx];

    int32_t levels[32 * 32];
    int last = -1;
    for (int i = 0; i < size * size; i++) {
      int x = scan[i] & 255, y = scan[i] >> 8;
      levels[i] = pl[(y0 + y) * stride + x0 + x];
      if (levels[i]) last = i;
    }
    int lx = scan[last] & 255, ly = scan[last] >> 8;
    if (scan_idx == 2) { int t = lx; lx = ly; ly = t; }
    encode_last_xy(lx, ly, log2_size, chroma);

    int n_sb = size >> 2;
    int last_sb = last >> 4, last_pos = last & 15;
    uint8_t csbf[8 * 8];
    std::memset(csbf, 0, sizeof(csbf));
    for (int i = 0; i <= last_sb; i++) {
      int sx = sbscan[i] & 255, sy = sbscan[i] >> 8;
      bool any = false;
      for (int n = 0; n < 16; n++) if (levels[i * 16 + n]) any = true;
      if (any) csbf[sy * n_sb + sx] = 1;
    }
    csbf[(sbscan[0] >> 8) * n_sb + (sbscan[0] & 255)] = 1;
    csbf[(sbscan[last_sb] >> 8) * n_sb + (sbscan[last_sb] & 255)] = 1;

    int gt1_state = 1;
    for (int i = last_sb; i >= 0; i--) {
      int sx = sbscan[i] & 255, sy = sbscan[i] >> 8;
      const int32_t *sb = levels + i * 16;
      bool infer_dc = false;
      int right = sx + 1 < n_sb ? csbf[sy * n_sb + sx + 1] : 0;
      int below = sy + 1 < n_sb ? csbf[(sy + 1) * n_sb + sx] : 0;
      if (i > 0 && i < last_sb) {
        c.bin(ctx.sig_cg[((right || below) ? 1 : 0) + (chroma ? 2 : 0)],
              csbf[sy * n_sb + sx]);
        infer_dc = true;
      }
      if (!csbf[sy * n_sb + sx]) continue;

      const uint8_t *stb =
          g_sigtbl[log2_size - 2][scan_idx][chroma ? 1 : 0]
                  [(sx | sy) ? 1 : 0][right + 2 * below];
      int start_n = (i == last_sb) ? last_pos - 1 : 15;
      for (int n = start_n; n >= 0; n--) {
        if (n > 0 || !infer_dc) {
          int sigv = sb[n] != 0;
          c.bin(ctx.sig[stb[n]], sigv);
          if (sigv) infer_dc = false;
        }
      }

      int sig_pos[16], n_sig = 0;
      for (int n = 15; n >= 0; n--) if (sb[n]) sig_pos[n_sig++] = n;
      if (!n_sig) continue;

      int ctx_set = (i == 0 || chroma) ? 0 : 2;
      if (gt1_state == 0) ctx_set++;
      gt1_state = 1;
      int first_gt1 = -1;
      int lim = n_sig < 8 ? n_sig : 8;
      for (int k = 0; k < lim; k++) {
        int n = sig_pos[k];
        int a = sb[n] < 0 ? -sb[n] : sb[n];
        int flag = a > 1;
        int inc = ctx_set * 4 + (gt1_state < 3 ? gt1_state : 3) +
                  (chroma ? 16 : 0);
        c.bin(ctx.gt1[inc], flag);
        if (flag) { gt1_state = 0; if (first_gt1 < 0) first_gt1 = n; }
        else if (gt1_state > 0 && gt1_state < 3) gt1_state++;
      }
      if (first_gt1 >= 0) {
        int a = sb[first_gt1] < 0 ? -sb[first_gt1] : sb[first_gt1];
        c.bin(ctx.gt2[ctx_set + (chroma ? 4 : 0)], a > 2);
      }
      bool hide = p.sign_hiding && !p.transquant_bypass && n_sig >= 2
                  && (sig_pos[0] - sig_pos[n_sig - 1] > 3);
      for (int k = 0; k < n_sig; k++) {
        if (hide && k == n_sig - 1) continue;
        c.bypass(sb[sig_pos[k]] < 0 ? 1 : 0);
      }
      int rice = 0;
      for (int k = 0; k < n_sig; k++) {
        int n = sig_pos[k];
        int a = sb[n] < 0 ? -sb[n] : sb[n];
        int base = k < 8 ? (n == first_gt1 ? 3 : 2) : 1;
        if (a >= base) {
          encode_remaining(a - base, rice);
          if (a > (3 << rice)) rice = rice < 4 ? rice + 1 : 4;
        }
      }
    }
  }
};

}  // namespace

// Row-parallel WPP drive: rows are claimed in order; row r seeds its
// contexts from row r-1's snapshot (published after its 2nd CTU), so
// threads run the classic wavefront stagger — the reference gets the
// same schedule from threadqueue deps (src/encoderstate.c:776-830).
static void encode_wpp_parallel(const FrameParams &fp,
                                std::vector<uint8_t> &out,
                                std::vector<int64_t> &sizes,
                                int nthreads) {
  int ctu = 1 << fp.log2_ctu;
  int ctus_x = (fp.width + ctu - 1) >> fp.log2_ctu;
  int ctus_y = (fp.height + ctu - 1) >> fp.log2_ctu;
  if (nthreads <= 1 || ctus_y < 3 || ctus_x < 2) {
    Serializer s(fp);
    s.encode_slice_wpp(out, sizes);
    return;
  }
  // One shared nonzero-cell bitmap set for every row worker.
  std::vector<uint8_t> shared_nz[3];
  {
    Serializer probe(fp);
    probe.build_nz4(0, shared_nz[0]);
    if (fp.chroma) {
      probe.build_nz4(1, shared_nz[1]);
      probe.build_nz4(2, shared_nz[2]);
    }
  }
  std::vector<Contexts> snaps(ctus_y);
  std::unique_ptr<std::atomic<int>[]> ready(
      new std::atomic<int>[ctus_y]);
  for (int i = 0; i < ctus_y; i++) ready[i].store(0);
  std::vector<std::vector<uint8_t>> rowbytes(ctus_y);
  std::atomic<int> next_row{0};
  auto worker = [&]() {
    for (;;) {
      int r = next_row.fetch_add(1);
      if (r >= ctus_y) return;
      Serializer s(fp);           // contexts init per slice type/qp
      s.shared_nz_ = shared_nz;
      if (r > 0) {
        while (!ready[r - 1].load(std::memory_order_acquire))
          std::this_thread::yield();
        s.ctx = snaps[r - 1];
      }
      s.encode_wpp_row(r, ctus_x, ctus_y, &snaps[r], &ready[r]);
      rowbytes[r] = std::move(s.c.bytes);
    }
  };
  int nt = nthreads < ctus_y ? nthreads : ctus_y;
  std::vector<std::thread> threads;
  for (int i = 0; i < nt - 1; i++) threads.emplace_back(worker);
  worker();
  for (auto &t : threads) t.join();
  for (int r = 0; r < ctus_y; r++) {
    sizes.push_back((int64_t)rowbytes[r].size());
    out.insert(out.end(), rowbytes[r].begin(), rowbytes[r].end());
  }
}

extern "C" {

// (H, W) int32 plane from (By*Bx, s, s) int8 raster-ordered blocks —
// the packed-transfer layout — widening as it copies.  Host-side fast
// path for FrameData assembly (GIL released under ctypes).
void ktpu_assemble_plane_i8(const int8_t *blocks, int bx, int by,
                            int s, int32_t *plane, int w, int h) {
  (void)h;
  for (int b = 0; b < by * bx; b++) {
    int y0 = (b / bx) * s, x0 = (b % bx) * s;
    const int8_t *src = blocks + (size_t)b * s * s;
    for (int r = 0; r < s; r++) {
      int32_t *dst = plane + (size_t)(y0 + r) * w + x0;
      const int8_t *sr = src + (size_t)r * s;
      for (int k = 0; k < s; k++) dst[k] = sr[k];
    }
  }
}

}  // extern "C"

extern "C" {

// Serialize slice data (CABAC, starting byte-aligned after the slice
// header) into out[]; returns byte count, or -1 if out_cap too small.
int64_t ktpu_encode_slice_data(
    int width, int height, int chroma, int qp,
    int log2_ctu, int log2_min_cu, int log2_max_tu,
    const uint8_t *depth8, const uint8_t *mode4,
    const int32_t *coeff_y, const int32_t *coeff_cb,
    const int32_t *coeff_cr,
    uint8_t *out, int64_t out_cap, int flags, const int8_t *sao,
    int32_t *qp_ctu, const uint8_t *cmode4) {
  FrameParams fp{width, height, chroma, qp, log2_ctu, log2_min_cu,
                 log2_max_tu, depth8, mode4, coeff_y, coeff_cb, coeff_cr};
  fp.sign_hiding = flags & 1;
  fp.sao = sao;
  fp.qp_ctu = qp_ctu;
  fp.dqp = qp_ctu != nullptr;
  fp.cmode4 = cmode4;
  Serializer s(fp);
  s.encode_slice();
  int64_t n = (int64_t)s.c.bytes.size();
  if (n > out_cap) return -1;
  std::memcpy(out, s.c.bytes.data(), (size_t)n);
  return n;
}

// P-slice variant with inter syntax arrays; wpp != 0 selects the
// per-row substream mode (entry_sizes/n_substreams as below, may be
// null when wpp == 0).
int64_t ktpu_encode_slice_data_p(
    int width, int height, int chroma, int qp, int wpp,
    int slice_type,
    int log2_ctu, int log2_min_cu, int log2_max_tu,
    const uint8_t *depth8, const uint8_t *mode4,
    const int32_t *coeff_y, const int32_t *coeff_cb,
    const int32_t *coeff_cr,
    const uint8_t *inter8, const uint8_t *skip8, const int8_t *merge8,
    const uint8_t *mvp8, const int32_t *mvd8,
    const uint8_t *dir8, const uint8_t *mvp8_l1,
    const int32_t *mvd8_l1,
    uint8_t *out, int64_t out_cap,
    int64_t *entry_sizes, int32_t *n_substreams, int flags,
    const int8_t *sao, const uint8_t *ref8, int nref_l0,
    const uint8_t *part8, int amp, int32_t *qp_ctu,
    const uint8_t *cmode4) {
  FrameParams fp{width, height, chroma, qp, log2_ctu, log2_min_cu,
                 log2_max_tu, depth8, mode4, coeff_y, coeff_cb,
                 coeff_cr, slice_type, 0, 0, inter8, skip8, merge8,
                 mvp8, mvd8, dir8, mvp8_l1, mvd8_l1};
  fp.sign_hiding = flags & 1;
  fp.sao = sao;
  fp.ref8 = ref8;
  fp.nref_l0 = nref_l0 > 0 ? nref_l0 : 1;
  fp.part8 = part8;
  fp.amp = amp;
  fp.qp_ctu = qp_ctu;
  fp.dqp = qp_ctu != nullptr;
  fp.cmode4 = cmode4;
  if (wpp) {
    std::vector<uint8_t> bytes;
    std::vector<int64_t> sizes;
    int nthreads = (flags >> 8) & 0xff;
    encode_wpp_parallel(fp, bytes, sizes,
                        nthreads > 0 ? nthreads : 1);
    int64_t n = (int64_t)bytes.size();
    if (n > out_cap) return -1;
    std::memcpy(out, bytes.data(), (size_t)n);
    for (size_t i = 0; i < sizes.size(); i++) entry_sizes[i] = sizes[i];
    *n_substreams = (int32_t)sizes.size();
    return n;
  }
  Serializer s(fp);
  s.encode_slice();
  int64_t n = (int64_t)s.c.bytes.size();
  if (n > out_cap) return -1;
  std::memcpy(out, s.c.bytes.data(), (size_t)n);
  if (n_substreams) *n_substreams = 1;
  return n;
}

// WPP variant: entry_sizes must hold >= height_in_ctus entries; the
// number of substreams is written to *n_substreams.
int64_t ktpu_encode_slice_data_wpp(
    int width, int height, int chroma, int qp,
    int log2_ctu, int log2_min_cu, int log2_max_tu,
    const uint8_t *depth8, const uint8_t *mode4,
    const int32_t *coeff_y, const int32_t *coeff_cb,
    const int32_t *coeff_cr,
    uint8_t *out, int64_t out_cap,
    int64_t *entry_sizes, int32_t *n_substreams, int flags,
    const int8_t *sao, int32_t *qp_ctu, const uint8_t *cmode4) {
  FrameParams fp{width, height, chroma, qp, log2_ctu, log2_min_cu,
                 log2_max_tu, depth8, mode4, coeff_y, coeff_cb, coeff_cr};
  fp.sign_hiding = flags & 1;
  fp.sao = sao;
  fp.qp_ctu = qp_ctu;
  fp.dqp = qp_ctu != nullptr;
  fp.cmode4 = cmode4;
  std::vector<uint8_t> bytes;
  std::vector<int64_t> sizes;
  int nthreads = (flags >> 8) & 0xff;
  encode_wpp_parallel(fp, bytes, sizes, nthreads > 0 ? nthreads : 1);
  int64_t n = (int64_t)bytes.size();
  if (n > out_cap) return -1;
  std::memcpy(out, bytes.data(), (size_t)n);
  for (size_t i = 0; i < sizes.size(); i++) entry_sizes[i] = sizes[i];
  *n_substreams = (int32_t)sizes.size();
  return n;
}

}  // extern "C"

extern "C" {

// Emulation prevention (H.265 7.4.2): insert 0x03 after 00 00 when the
// next byte is <= 3.  Returns output length (worst case in_len * 3 / 2).
int64_t ktpu_emulation_prevention(const uint8_t *in, int64_t in_len,
                                  uint8_t *out, int64_t out_cap) {
  int64_t o = 0;
  int zeros = 0;
  for (int64_t i = 0; i < in_len; i++) {
    uint8_t b = in[i];
    if (zeros >= 2 && b <= 3) {
      if (o >= out_cap) return -1;
      out[o++] = 3;
      zeros = 0;
    }
    if (o >= out_cap) return -1;
    out[o++] = b;
    zeros = (b == 0) ? zeros + 1 : 0;
  }
  return o;
}

}  // extern "C"
