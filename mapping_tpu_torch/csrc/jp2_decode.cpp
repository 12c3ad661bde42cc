// JPEG 2000 codestreams (ITU-T T.800, Part 1) on the host, for
// mapping_tpu_torch/utils/jp2.py. The JAX package reads JPEG 2000 through
// Pillow, which decodes with openjpeg 2.5 tile by tile
// (opj_read_tile_header / opj_decode_tile_data); this decoder gives the
// same component samples, following openjpeg where the standard leaves a
// choice or where openjpeg departs from it:
//
// - markers: the main header (SIZ first; COD, COC, QCD, QCC, RGN, POC,
//   PPM, TLM, PLM, CRG, COM; an unknown marker is skipped two bytes at a
//   time up to the next known one) and tile-part headers (COD, COC, QCD,
//   QCC, RGN, POC, PPT, PLT, COM); a COD or QCD applies to every
//   component, so one read after a COC or QCC of its header replaces it;
//   a tile header's POC adds to the main header's; tile-parts are taken
//   in order, a Psot of 0 runs to two bytes before the end, and a
//   tile-part longer than the data left is refused (openjpeg's strict
//   mode, its default);
// - tier 2: the packets of each tile in its progression order (LRCP,
//   RLCP, RPCL, PCRL, CPRL; POC entries in turn, a packet met again
//   skipped), headers from the tile-part body, PPT or PPM, SOP and EPH
//   skipped where present, tag trees for inclusion and zero bit-planes,
//   segment lengths under TERMALL and BYPASS; a segment that runs past the
//   data is refused;
// - tier 1: the MQ decoder (0xFF 0xFF read past a segment's end), the
//   three passes with T.800's contexts, and every code-block style bit
//   (BYPASS, RESET, TERMALL, VSC, ERTERM, SEGSYM); samples carry one more
//   bit than the standard's, the half-step of reconstruction, as
//   openjpeg's do;
// - reconstruction, from per-subband coefficient planes: ROI max-shift,
//   dequantisation (5/3: halved; 9/7: a float times half of openjpeg's
//   step, which leaves out the sub-band gain since its 9/7 scales the high
//   pass by 1.625732422 where T.800 has 1/K), the inverse wavelet (5/3
//   integer lifting; 9/7 float lifting in openjpeg's order: K and
//   1.625732422, then delta, gamma, beta, alpha, a one-sample signal left
//   as it is), the RCT or ICT over the first three components, the DC
//   shift with lrintf and the clip.
//
// The float path must not contract a*b + c into an FMA: the library is
// built with -ffp-contract=off (utils/jp2.py), so that every host gives
// the bytes openjpeg gives on x86-64.
//
// Refused, each with a ValueError that names it: HTJ2K (a CAP marker, Rsiz
// bit 14, or an HT code-block style), Part 2 multi-component transforms,
// and every stream openjpeg fails on.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Refusal {
  std::string what;
};

[[noreturn]] void refuse(const std::string& what) { throw Refusal{what}; }

constexpr int kMaxRes = 33;
constexpr int kMaxBands = 3 * kMaxRes - 2;
constexpr uint32_t kCspPrt = 1, kCspSop = 2, kCspEph = 4;
constexpr uint32_t kLazy = 1, kReset = 2, kTermAll = 4, kVsc = 8,
                   kSegSym = 32, kHt = 0x40, kHtMixed = 0x80;

inline int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline int64_t ceildivpow2(int64_t a, int b) {
  return (a + (int64_t(1) << b) - 1) >> b;
}
inline int64_t floordivpow2(int64_t a, int b) { return a >> b; }

// ----------------------------------------------------------- parameters

struct StepSize {
  int32_t expn = 0, mant = 0;
};

struct Tccp {
  uint32_t csty = 0, numres = 0, cblkw = 0, cblkh = 0, cblksty = 0;
  uint32_t qmfbid = 0, qntsty = 0, numgbits = 0;
  int32_t roishift = 0;
  StepSize steps[kMaxBands];
  uint32_t prcw[kMaxRes] = {}, prch[kMaxRes] = {};
};

struct Poc {
  uint32_t resno0, compno0, layno1, resno1, compno1, prg;
};

struct Tcp {
  uint32_t csty = 0, prg = 0, numlayers = 0, mct = 0;
  bool cod = false, poc = false, ppt = false;
  std::vector<Tccp> tccps;
  std::vector<Poc> pocs;
  std::vector<std::vector<uint8_t>> ppt_markers;
  std::vector<bool> ppt_seen;
  std::vector<uint8_t> ppt_data;
  std::vector<uint8_t> data;  // tile-part bodies, in order
  bool has_data = false;
  int32_t cur_part = -1;
  uint32_t nb_parts = 0;
};

struct Comp {
  uint32_t dx, dy, prec, sgnd;
  int64_t x0, y0, w, h;  // on the component's grid
  uint32_t resno_decoded = 0;
};

struct Reader {
  const uint8_t* p;
  size_t n, pos = 0;
  Reader(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
  size_t left() const { return n - pos; }
  uint32_t get(int bytes) {
    if (left() < size_t(bytes)) refuse("a JPEG 2000 marker segment cut short");
    uint32_t v = 0;
    for (int i = 0; i < bytes; ++i) v = (v << 8) | p[pos++];
    return v;
  }
};

enum : uint32_t { kMs_Siz = 1, kMs_Mh = 2, kMs_Tph = 4, kMs_TphSot = 8 };

enum Marker : uint32_t {
  SOC = 0xff4f, SOT = 0xff90, SOD = 0xff93, EOC = 0xffd9, CAP = 0xff50,
  SIZ = 0xff51, COD = 0xff52, COC = 0xff53, CPF = 0xff59, TLM = 0xff55,
  PLM = 0xff57, PLT = 0xff58, QCD = 0xff5c, QCC = 0xff5d, RGN = 0xff5e,
  POC = 0xff5f, PPM = 0xff60, PPT = 0xff61, CRG = 0xff63, COM = 0xff64,
  SOP = 0xff91, MCT = 0xff74, MCC = 0xff75, MCO = 0xff77, CBD = 0xff78
};

// the states in which openjpeg takes a marker; 0 for one it does not know
uint32_t marker_states(uint32_t m) {
  switch (m) {
    case SOT: return kMs_Mh | kMs_TphSot;
    case COD: case COC: case RGN: case QCD: case QCC: case POC: case COM:
    case MCT: case MCC: case MCO:
      return kMs_Mh | kMs_Tph;
    case SIZ: return kMs_Siz;
    case TLM: case PLM: case PPM: case CRG: case CBD: case CAP: case CPF:
      return kMs_Mh;
    case PLT: case PPT: return kMs_Tph;
    case SOP: return 0x100;  // known, and in place nowhere
    default: return 0;
  }
}

// ------------------------------------------------------------ codestream

struct Codestream {
  const uint8_t* d;
  size_t n;
  uint32_t rsiz = 0;
  int64_t X0 = 0, Y0 = 0, X1 = 0, Y1 = 0;
  int64_t tx0 = 0, ty0 = 0, tdx = 0, tdy = 0;
  uint32_t tw = 0, th = 0;
  std::vector<Comp> comps;
  Tcp deft;
  std::vector<Tcp> tcps;
  bool has_siz = false, has_cod = false, has_qcd = false;
  bool ppm = false;
  std::vector<std::vector<uint8_t>> ppm_markers;
  std::vector<bool> ppm_seen;
  std::vector<uint8_t> ppm_data;
  size_t ppm_pos = 0;

  uint32_t comp_room() const { return comps.size() <= 256 ? 1 : 2; }

  void read_siz(Reader& r, size_t size) {
    if (size < 36) refuse("a JPEG 2000 SIZ marker of the wrong size");
    if ((size - 36) % 3) refuse("a JPEG 2000 SIZ marker of the wrong size");
    rsiz = r.get(2);
    X1 = r.get(4); Y1 = r.get(4); X0 = r.get(4); Y0 = r.get(4);
    tdx = r.get(4); tdy = r.get(4); tx0 = r.get(4); ty0 = r.get(4);
    uint32_t nc = r.get(2);
    if (nc == 0 || nc > 16384 || nc != (size - 36) / 3)
      refuse("a JPEG 2000 SIZ marker with a bad component count");
    if (rsiz & 0x4000) refuse("HTJ2K (High Throughput JPEG 2000)");
    if (X0 >= X1 || Y0 >= Y1) refuse("a JPEG 2000 image of no pixels");
    if (tdx == 0 || tdy == 0) refuse("a JPEG 2000 tile size of 0");
    int64_t tx1 = std::min<int64_t>(tx0 + tdx, 0xffffffffLL);
    int64_t ty1 = std::min<int64_t>(ty0 + tdy, 0xffffffffLL);
    if (tx0 > X0 || ty0 > Y0 || tx1 <= X0 || ty1 <= Y0)
      refuse("a JPEG 2000 tile grid that misses the image");
    comps.resize(nc);
    for (auto& c : comps) {
      uint32_t s = r.get(1);
      c.prec = (s & 0x7f) + 1;
      c.sgnd = s >> 7;
      c.dx = r.get(1);
      c.dy = r.get(1);
      if (c.dx < 1 || c.dy < 1)
        refuse("a JPEG 2000 component subsampling of 0");
      if (c.prec > 31) refuse("a JPEG 2000 precision past 31 bits");
      c.x0 = ceildiv(X0, c.dx);
      c.y0 = ceildiv(Y0, c.dy);
      c.w = ceildiv(X1, c.dx) - c.x0;
      c.h = ceildiv(Y1, c.dy) - c.y0;
    }
    tw = uint32_t(ceildiv(X1 - tx0, tdx));
    th = uint32_t(ceildiv(Y1 - ty0, tdy));
    if (tw == 0 || th == 0 || tw > 65535 / th)
      refuse("a JPEG 2000 tile count past 65535");
    deft.tccps.assign(nc, Tccp());
    has_siz = true;
  }

  // SPcod / SPcoc into tccp; `size` is what is left of the segment
  void read_spcod(Reader& r, size_t& size, Tccp& t) {
    if (size < 5) refuse("a JPEG 2000 COD or COC marker cut short");
    t.numres = r.get(1) + 1;
    if (t.numres > kMaxRes)
      refuse("JPEG 2000 decomposition levels past 32");
    t.cblkw = r.get(1) + 2;
    t.cblkh = r.get(1) + 2;
    if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12)
      refuse("a JPEG 2000 code-block size past the limits");
    t.cblksty = r.get(1);
    if (t.cblksty & (kHt | kHtMixed))
      refuse("HTJ2K (High Throughput JPEG 2000)");
    t.qmfbid = r.get(1);
    if (t.qmfbid > 1) refuse("a JPEG 2000 wavelet other than 5/3 or 9/7");
    size -= 5;
    if (t.csty & kCspPrt) {
      if (size < t.numres) refuse("a JPEG 2000 COD or COC marker cut short");
      for (uint32_t i = 0; i < t.numres; ++i) {
        uint32_t v = r.get(1);
        if (i != 0 && ((v & 0xf) == 0 || (v >> 4) == 0))
          refuse("a JPEG 2000 precinct size of 1 above resolution 0");
        t.prcw[i] = v & 0xf;
        t.prch[i] = v >> 4;
      }
      size -= t.numres;
    } else {
      for (uint32_t i = 0; i < t.numres; ++i) t.prcw[i] = t.prch[i] = 15;
    }
  }

  void read_cod(Reader& r, size_t size, Tcp& t) {
    if (t.cod) refuse("two JPEG 2000 COD markers in one header");
    t.cod = true;
    if (size < 5) refuse("a JPEG 2000 COD marker cut short");
    t.csty = r.get(1);
    if (t.csty & ~(kCspPrt | kCspSop | kCspEph))
      refuse("a JPEG 2000 COD marker with unknown coding style bits");
    t.prg = r.get(1);
    if (t.prg > 4) t.prg = 0xffffffff;  // fails at the first tile
    t.numlayers = r.get(2);
    if (t.numlayers < 1) refuse("a JPEG 2000 COD marker with no layers");
    t.mct = r.get(1);
    if (t.mct > 1) refuse("a JPEG 2000 Part 2 multi-component transform");
    size -= 5;
    for (auto& c : t.tccps) c.csty = t.csty & kCspPrt;
    read_spcod(r, size, t.tccps[0]);
    if (size != 0) refuse("a JPEG 2000 COD marker of the wrong size");
    for (size_t i = 1; i < t.tccps.size(); ++i) {
      Tccp& c = t.tccps[i];
      const Tccp& s = t.tccps[0];
      c.numres = s.numres; c.cblkw = s.cblkw; c.cblkh = s.cblkh;
      c.cblksty = s.cblksty; c.qmfbid = s.qmfbid;
      std::memcpy(c.prcw, s.prcw, sizeof c.prcw);
      std::memcpy(c.prch, s.prch, sizeof c.prch);
    }
    has_cod = true;
  }

  void read_coc(Reader& r, size_t size, Tcp& t) {
    uint32_t room = comp_room();
    if (size < room + 1) refuse("a JPEG 2000 COC marker cut short");
    size -= room + 1;
    uint32_t c = r.get(room);
    if (c >= comps.size()) refuse("a JPEG 2000 COC marker for no component");
    t.tccps[c].csty = r.get(1);
    read_spcod(r, size, t.tccps[c]);
    if (size != 0) refuse("a JPEG 2000 COC marker of the wrong size");
  }

  void read_sqcd(Reader& r, size_t& size, Tccp& t) {
    if (size < 1) refuse("a JPEG 2000 QCD or QCC marker cut short");
    size -= 1;
    uint32_t v = r.get(1);
    t.qntsty = v & 0x1f;
    t.numgbits = v >> 5;
    size_t nb;
    if (t.qntsty == 1) nb = 1;
    else nb = t.qntsty == 0 ? size : size / 2;
    if (t.qntsty == 0) {
      for (size_t b = 0; b < nb; ++b) {
        uint32_t e = r.get(1);
        if (b < kMaxBands) { t.steps[b].expn = e >> 3; t.steps[b].mant = 0; }
      }
      size -= nb;
    } else {
      if (size < 2 * nb) refuse("a JPEG 2000 QCD or QCC marker cut short");
      for (size_t b = 0; b < nb; ++b) {
        uint32_t e = r.get(2);
        if (b < kMaxBands) {
          t.steps[b].expn = e >> 11;
          t.steps[b].mant = e & 0x7ff;
        }
      }
      size -= 2 * nb;
    }
    if (t.qntsty == 1)
      for (int b = 1; b < kMaxBands; ++b) {
        int32_t e = t.steps[0].expn - (b - 1) / 3;
        t.steps[b].expn = e > 0 ? e : 0;
        t.steps[b].mant = t.steps[0].mant;
      }
  }

  void read_qcd(Reader& r, size_t size, Tcp& t) {
    read_sqcd(r, size, t.tccps[0]);
    if (size != 0) refuse("a JPEG 2000 QCD marker of the wrong size");
    for (size_t i = 1; i < t.tccps.size(); ++i) {
      t.tccps[i].qntsty = t.tccps[0].qntsty;
      t.tccps[i].numgbits = t.tccps[0].numgbits;
      std::memcpy(t.tccps[i].steps, t.tccps[0].steps, sizeof t.tccps[0].steps);
    }
    has_qcd = true;
  }

  void read_qcc(Reader& r, size_t size, Tcp& t) {
    uint32_t room = comp_room();
    if (size < room) refuse("a JPEG 2000 QCC marker cut short");
    uint32_t c = r.get(room);
    size -= room;
    if (c >= comps.size()) refuse("a JPEG 2000 QCC marker for no component");
    read_sqcd(r, size, t.tccps[c]);
    if (size != 0) refuse("a JPEG 2000 QCC marker of the wrong size");
  }

  void read_rgn(Reader& r, size_t size, Tcp& t) {
    uint32_t room = comp_room();
    if (size != 2 + room) refuse("a JPEG 2000 RGN marker of the wrong size");
    uint32_t c = r.get(room);
    r.get(1);
    if (c >= comps.size()) refuse("a JPEG 2000 RGN marker for no component");
    t.tccps[c].roishift = int32_t(r.get(1));
  }

  void read_poc(Reader& r, size_t size, Tcp& t) {
    uint32_t room = comp_room();
    size_t chunk = 5 + 2 * room;
    size_t nb = size / chunk;
    if (nb == 0 || size % chunk) refuse("a JPEG 2000 POC marker of the wrong size");
    size_t old = t.poc ? t.pocs.size() : 0;
    if (old + nb >= 32) refuse("more than 31 JPEG 2000 progression changes");
    if (!t.poc) t.pocs.clear();
    for (size_t i = 0; i < nb; ++i) {
      Poc p;
      p.resno0 = r.get(1);
      p.compno0 = r.get(room);
      p.layno1 = std::min(r.get(2), t.numlayers);
      p.resno1 = r.get(1);
      p.compno1 = std::min<uint32_t>(r.get(room), uint32_t(comps.size()));
      p.prg = r.get(1);
      t.pocs.push_back(p);
    }
    t.poc = true;
  }

  void read_ppm(Reader& r, size_t size) {
    if (size < 2) refuse("a JPEG 2000 PPM marker cut short");
    ppm = true;
    uint32_t z = r.get(1);
    if (ppm_markers.size() <= z) {
      ppm_markers.resize(z + 1);
      ppm_seen.resize(z + 1, false);
    }
    if (ppm_seen[z]) refuse("two JPEG 2000 PPM markers of one index");
    ppm_seen[z] = true;
    ppm_markers[z].assign(r.p + r.pos, r.p + r.pos + size - 1);
    r.pos += size - 1;
  }

  void read_ppt(Reader& r, size_t size, Tcp& t) {
    if (size < 2) refuse("a JPEG 2000 PPT marker cut short");
    if (ppm) refuse("JPEG 2000 PPT markers after a PPM marker");
    t.ppt = true;
    uint32_t z = r.get(1);
    if (t.ppt_markers.size() <= z) {
      t.ppt_markers.resize(z + 1);
      t.ppt_seen.resize(z + 1, false);
    }
    if (t.ppt_seen[z]) refuse("two JPEG 2000 PPT markers of one index");
    t.ppt_seen[z] = true;
    t.ppt_markers[z].assign(r.p + r.pos, r.p + r.pos + size - 1);
    r.pos += size - 1;
  }

  void read_plt(Reader& r, size_t size) {
    if (size < 1) refuse("a JPEG 2000 PLT marker cut short");
    r.get(1);
    uint32_t len = 0;
    for (size_t i = 1; i < size; ++i) {
      uint32_t v = r.get(1);
      len |= v & 0x7f;
      if (v & 0x80) len <<= 7;
      else len = 0;
    }
    if (len != 0) refuse("a JPEG 2000 PLT marker cut inside a length");
  }

  void merge_ppm() {
    if (!ppm) return;
    // Nppm, then that many bytes of packet headers, over the markers
    uint32_t remaining = 0;
    for (size_t i = 0; i < ppm_markers.size(); ++i) {
      if (!ppm_seen[i]) continue;
      const auto& m = ppm_markers[i];
      size_t k = 0;
      while (k < m.size()) {
        if (remaining) {
          size_t take = std::min<size_t>(remaining, m.size() - k);
          ppm_data.insert(ppm_data.end(), m.begin() + k, m.begin() + k + take);
          k += take;
          remaining -= uint32_t(take);
          continue;
        }
        // openjpeg requires each Nppm whole within one marker
        if (m.size() - k < 4) refuse("a JPEG 2000 PPM marker cut inside Nppm");
        remaining = (uint32_t(m[k]) << 24) | (uint32_t(m[k + 1]) << 16) |
                    (uint32_t(m[k + 2]) << 8) | m[k + 3];
        k += 4;
      }
    }
    if (remaining) refuse("JPEG 2000 PPM markers cut short");
  }

  void parse() {
    if (n < 2 || d[0] != 0xff || d[1] != 0x4f)
      refuse("not a JPEG 2000 codestream");
    Reader r(d, n);
    r.pos = 2;
    uint32_t state = kMs_Siz;
    if (r.left() < 2) refuse("a JPEG 2000 main header cut short");
    uint32_t m = r.get(2);
    while (m != SOT) {
      if (m < 0xff00) refuse("a JPEG 2000 main header without a marker");
      uint32_t st = marker_states(m);
      if (st == 0) {
        // openjpeg's read_unk: two bytes at a time to a known marker
        for (;;) {
          if (r.left() < 2) refuse("a JPEG 2000 main header cut short");
          m = r.get(2);
          if (m >= 0xff00) {
            st = marker_states(m);
            if (st && !(state & st))
              refuse("a JPEG 2000 marker out of place");
            if (st) break;
          }
        }
        if (m == SOT) break;
      }
      if (m == CAP) refuse("HTJ2K (High Throughput JPEG 2000)");
      if (m == MCT || m == MCC || m == MCO || m == CBD)
        refuse("a JPEG 2000 Part 2 multi-component transform");
      if (!(state & st)) refuse("a JPEG 2000 marker out of place");
      if (r.left() < 2) refuse("a JPEG 2000 main header cut short");
      uint32_t len = r.get(2);
      if (len < 2) refuse("a JPEG 2000 marker of a bad length");
      size_t size = len - 2;
      if (r.left() < size) refuse("a JPEG 2000 main header cut short");
      Reader seg(r.p + r.pos, size);
      switch (m) {
        case SIZ: read_siz(seg, size); state = kMs_Mh; break;
        case COD: read_cod(seg, size, deft); break;
        case COC: read_coc(seg, size, deft); break;
        case QCD: read_qcd(seg, size, deft); break;
        case QCC: read_qcc(seg, size, deft); break;
        case RGN: read_rgn(seg, size, deft); break;
        case POC: read_poc(seg, size, deft); break;
        case PPM: read_ppm(seg, size); break;
        case CRG:
          if (size != comps.size() * 4)
            refuse("a JPEG 2000 CRG marker of the wrong size");
          break;
        default: break;  // TLM, PLM, COM, CPF
      }
      r.pos += size;
      if (r.left() < 2) refuse("a JPEG 2000 main header cut short");
      m = r.get(2);
    }
    if (!has_siz) refuse("a JPEG 2000 codestream without SIZ");
    if (!has_cod) refuse("a JPEG 2000 codestream without COD");
    if (!has_qcd) refuse("a JPEG 2000 codestream without QCD");
    merge_ppm();
    pos = r.pos;  // past the first SOT
    tcps.assign(size_t(tw) * th, deft);
    for (auto& t : tcps) {
      t.cod = false;
      t.ppt = false;
    }
  }

  // ---- tile-parts, as openjpeg's opj_read_tile_header and the end of
  // its opj_decode_tile_data read them, one tile at a time

  enum DecState { kTphSot, kTph, kNeoc, kEoc };
  size_t pos = 0;
  DecState dstate = kTphSot;
  uint32_t cur_tile = 0;
  bool last_part = false;
  int64_t sot_length = 0;

  uint32_t get2() {
    if (n - pos < 2) refuse("a JPEG 2000 codestream cut short");
    uint32_t v = (uint32_t(d[pos]) << 8) | d[pos + 1];
    pos += 2;
    return v;
  }

  // SOT: the tile-part's tile and length; whether the tile is now whole
  bool read_sot(Reader& seg, size_t size) {
    if (size != 8) refuse("a JPEG 2000 SOT marker of the wrong size");
    uint32_t isot = seg.get(2), psot = seg.get(4), tpsot = seg.get(1),
             tnsot = seg.get(1);
    if (isot >= tcps.size()) refuse("a JPEG 2000 tile index past the tiles");
    cur_tile = isot;
    Tcp& t = tcps[isot];
    if (psot != 0 && psot < 14 && psot != 12)
      refuse("a JPEG 2000 tile-part length below its header");
    if (int32_t(tpsot) != t.cur_part + 1)
      refuse("JPEG 2000 tile-parts out of order");
    t.cur_part = int32_t(tpsot);
    last_part = psot == 0;
    if (t.nb_parts && tpsot >= t.nb_parts)
      refuse("a JPEG 2000 tile-part index past its count");
    if (tnsot) {
      if (tpsot >= tnsot) refuse("a JPEG 2000 tile-part index past its count");
      t.nb_parts = tnsot;
    }
    sot_length = last_part ? 0 : int64_t(psot) - 12;
    dstate = kTph;
    return t.nb_parts && t.nb_parts == tpsot + 1u;
  }

  void read_sod() {
    Tcp& t = tcps[cur_tile];
    int64_t body;
    if (last_part) {
      body = int64_t(n - pos) - 2;
    } else {
      body = sot_length >= 2 ? sot_length - 2 : sot_length;
    }
    if (body < 0 || body > int64_t(n - pos))
      refuse("a JPEG 2000 tile-part longer than the data left");
    t.data.insert(t.data.end(), d + pos, d + pos + body);
    t.has_data = true;
    pos += size_t(body);
    dstate = kTphSot;
  }

  // the next tile to decode, or false when there is none
  bool next_tile(uint32_t* tile) {
    uint32_t m;
    if (dstate == kEoc) m = EOC;
    else if (dstate != kTphSot) refuse("a JPEG 2000 codestream cut short");
    else m = SOT;
    bool can_decode = false;
    while (!can_decode && m != EOC) {
      while (m != SOD) {
        if (pos == n) {
          dstate = kNeoc;
          break;
        }
        uint32_t len = get2();
        if (len < 2) refuse("a JPEG 2000 marker of a bad length");
        if (m == 0x8080 && pos == n) {
          dstate = kNeoc;
          break;
        }
        if (dstate == kTph && sot_length != 0) {
          if (sot_length < int64_t(len) + 2)
            refuse("a JPEG 2000 tile-part header longer than its tile-part");
          sot_length -= len + 2;
        }
        size_t size = len - 2;
        uint32_t st = marker_states(m);
        uint32_t now = dstate == kTph ? kMs_Tph : kMs_TphSot;
        if (m == MCT || m == MCC || m == MCO)
          refuse("a JPEG 2000 Part 2 multi-component transform");
        if (!(now & st)) refuse("a JPEG 2000 marker out of place");
        if (n - pos < size) refuse("a JPEG 2000 tile-part header cut short");
        Reader seg(d + pos, size);
        Tcp& t = tcps[cur_tile];
        switch (m) {
          case SOT: can_decode = read_sot(seg, size); break;
          case COD: read_cod(seg, size, t); break;
          case COC: read_coc(seg, size, t); break;
          case QCD: read_qcd(seg, size, t); break;
          case QCC: read_qcc(seg, size, t); break;
          case RGN: read_rgn(seg, size, t); break;
          case POC: read_poc(seg, size, t); break;
          case PPT: read_ppt(seg, size, t); break;
          case PLT: read_plt(seg, size); break;
          default: break;  // COM
        }
        pos += size;
        m = get2();
      }
      if (pos == n && dstate == kNeoc) break;
      read_sod();
      if (!can_decode) {
        if (n - pos < 2) {
          // openjpeg: tiles of one tile-part with TPsot == TNsot == 0
          // and no EOC (SPOT6 files), else "stream too short"
          bool spot6 = false;
          if (cur_tile + 1 == tcps.size())
            for (size_t i = 0; i < tcps.size(); ++i)
              if (tcps[i].cur_part == 0 && tcps[i].nb_parts == 0) {
                spot6 = true;
                cur_tile = uint32_t(i);
                break;
              }
          if (!spot6) refuse("a JPEG 2000 codestream cut short");
          m = EOC;
          dstate = kEoc;
          break;
        }
        m = get2();
      }
    }
    if (m == EOC && dstate != kEoc) {
      cur_tile = 0;
      dstate = kEoc;
    }
    if (!can_decode) {
      while (cur_tile < tcps.size() && !tcps[cur_tile].has_data) ++cur_tile;
      if (cur_tile == tcps.size()) return false;
    }
    *tile = cur_tile;
    return true;
  }

  // openjpeg's end of opj_j2k_decode_tile: the tile's data freed, then
  // the next marker read
  void after_decode(uint32_t tile) {
    std::vector<uint8_t>().swap(tcps[tile].data);
    tcps[tile].has_data = false;
    if (pos == n && dstate == kNeoc) return;
    if (dstate != kEoc) {
      uint32_t m = get2();
      if (m == EOC) {
        cur_tile = 0;
        dstate = kEoc;
      } else if (m != SOT) {
        if (pos == n) dstate = kNeoc;
        else refuse("a JPEG 2000 marker out of place");
      }
    }
  }
};

// ------------------------------------------------------------- tier 2

struct Bio {
  const uint8_t* bp;
  const uint8_t* start;
  const uint8_t* end;
  uint32_t buf = 0, ct = 0;
  Bio(const uint8_t* p, size_t len) : bp(p), start(p), end(p + len) {}
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    ct--;
    return (buf >> ct) & 1;
  }
  uint32_t read(uint32_t n) {
    uint32_t v = 0;
    for (uint32_t i = n; i > 0; --i) v |= bit() << (i - 1);
    return v;
  }
  void inalign() {
    if ((buf & 0xff) == 0xff) bytein();
    ct = 0;
  }
  size_t numbytes() const { return size_t(bp - start); }
};

struct TagTree {
  struct Node {
    int parent;
    int32_t value, low;
  };
  std::vector<Node> nodes;
  void create(uint32_t w, uint32_t h) {
    nodes.clear();
    if (w == 0 || h == 0) return;
    std::vector<uint32_t> ws, hs;
    uint32_t nw = w, nh = h;
    size_t total = 0;
    for (;;) {
      ws.push_back(nw);
      hs.push_back(nh);
      total += size_t(nw) * nh;
      if (nw == 1 && nh == 1) break;
      nw = (nw + 1) / 2;
      nh = (nh + 1) / 2;
    }
    nodes.assign(total, Node{-1, 999, 0});
    size_t base = 0;
    for (size_t l = 0; l + 1 < ws.size(); ++l) {
      size_t next = base + size_t(ws[l]) * hs[l];
      for (uint32_t j = 0; j < hs[l]; ++j)
        for (uint32_t i = 0; i < ws[l]; ++i)
          nodes[base + size_t(j) * ws[l] + i].parent =
              int(next + size_t(j / 2) * ws[l + 1] + i / 2);
      base = next;
    }
  }
  void reset() {
    for (auto& nd : nodes) { nd.value = 999; nd.low = 0; }
  }
  uint32_t decode(Bio& bio, uint32_t leaf, int32_t threshold) {
    int stk[64];
    int sp = 0;
    int node = int(leaf);
    while (nodes[node].parent >= 0) {
      stk[sp++] = node;
      node = nodes[node].parent;
    }
    int32_t low = 0;
    for (;;) {
      Node& nd = nodes[node];
      if (low > nd.low) nd.low = low;
      else low = nd.low;
      while (low < threshold && low < nd.value) {
        if (bio.bit()) nd.value = low;
        else ++low;
      }
      nd.low = low;
      if (sp == 0) break;
      node = stk[--sp];
    }
    return nodes[node].value < threshold ? 1 : 0;
  }
};

struct Seg {
  uint32_t len = 0, numpasses = 0, real_num_passes = 0, maxpasses = 0;
  uint32_t numnewpasses = 0, newlen = 0;
};

struct Cblk {
  int64_t x0, y0, x1, y1;
  uint32_t numbps = 0, numlenbits = 0, numnewpasses = 0;
  uint32_t numsegs = 0, real_num_segs = 0;
  std::vector<Seg> segs;
  std::vector<std::pair<size_t, uint32_t>> chunks;  // offset into tile data
};

struct Prec {
  int64_t x0, y0, x1, y1;
  uint32_t cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  uint32_t bandno = 0;
  int64_t x0, y0, x1, y1;
  int32_t numbps = 0;
  float stepsize = 0;
  std::vector<Prec> precs;
  std::vector<uint32_t> coef;  // the sub-band plane: int32, or float bits
  bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Res {
  int64_t x0, y0, x1, y1;
  uint32_t pw = 0, ph = 0, pdx = 0, pdy = 0, numbands = 0;
  Band bands[3];
};

struct TileComp {
  int64_t x0, y0, x1, y1;
  uint32_t numres = 0;
  std::vector<Res> res;
  std::vector<uint32_t> data;  // int32, or float bits for 9/7
};

void init_seg(Cblk& c, uint32_t index, uint32_t cblksty, bool first) {
  if (c.segs.size() <= index) c.segs.resize(index + 1);
  Seg& s = c.segs[index];
  s = Seg();
  if (cblksty & kTermAll) s.maxpasses = 1;
  else if (cblksty & kLazy) {
    if (first) s.maxpasses = 10;
    else {
      uint32_t prev = c.segs[index - 1].maxpasses;
      s.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
    }
  } else {
    s.maxpasses = 109;
  }
}

uint32_t getnumpasses(Bio& bio) {
  uint32_t n;
  if (!bio.read(1)) return 1;
  if (!bio.read(1)) return 2;
  if ((n = bio.read(2)) != 3) return 3 + n;
  if ((n = bio.read(5)) != 31) return 6 + n;
  return 37 + bio.read(7);
}

uint32_t floorlog2(uint32_t a) {
  uint32_t l = 0;
  while (a > 1) { a >>= 1; ++l; }
  return l;
}

struct Packet {
  uint32_t layno, resno, compno, precno;
};

// ------------------------------------------------------------- tier 1

struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

constexpr MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0ac1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1c01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1c01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0ac1, 31, 28, 0}, {0x09c1, 32, 29, 0}, {0x08a1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02a1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

constexpr int kCtxZc = 0, kCtxSc = 9, kCtxMag = 14, kCtxAgg = 17,
              kCtxUni = 18, kNumCtx = 19;

// the MQ decoder and the raw (bypass) reader, over one segment with the
// two 0xFF bytes openjpeg appends
struct Mq {
  std::vector<uint8_t> buf;
  const uint8_t* bp = nullptr;
  uint32_t a = 0, c = 0, ct = 0;
  uint8_t state[kNumCtx], mps[kNumCtx];

  void reset_states() {
    for (int i = 0; i < kNumCtx; ++i) { state[i] = 0; mps[i] = 0; }
    state[kCtxUni] = 46;
    state[kCtxAgg] = 3;
    state[kCtxZc] = 4;
  }
  void set(const uint8_t* p, uint32_t len) {
    buf.assign(p, p + len);
    buf.push_back(0xff);
    buf.push_back(0xff);
    bp = buf.data();
  }
  void bytein() {
    if (*bp == 0xff) {
      if (bp[1] > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        bp++;
        c += uint32_t(*bp) << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += uint32_t(*bp) << 8;
      ct = 8;
    }
  }
  void init_dec(const uint8_t* p, uint32_t len) {
    set(p, len);
    c = len == 0 ? 0xffu << 16 : uint32_t(*bp) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void raw_init_dec(const uint8_t* p, uint32_t len) {
    set(p, len);
    c = 0;
    ct = 0;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      ct--;
    } while (a < 0x8000);
  }
  uint32_t decode(int cx) {
    const MqState& s = kMq[state[cx]];
    uint32_t d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {
      if (a < s.qe) {
        a = s.qe;
        d = mps[cx];
        state[cx] = s.nmps;
      } else {
        a = s.qe;
        d = 1 - mps[cx];
        if (s.sw) mps[cx] = uint8_t(1 - mps[cx]);
        state[cx] = s.nlps;
      }
      renorm();
    } else {
      c -= uint32_t(s.qe) << 16;
      if ((a & 0x8000) == 0) {
        if (a < s.qe) {
          d = 1 - mps[cx];
          if (s.sw) mps[cx] = uint8_t(1 - mps[cx]);
          state[cx] = s.nlps;
        } else {
          d = mps[cx];
          state[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  uint32_t raw() {
    if (ct == 0) {
      if (c == 0xff) {
        if (*bp > 0x8f) {
          c = 0xff;
          ct = 8;
        } else {
          c = *bp;
          bp++;
          ct = 7;
        }
      } else {
        c = *bp;
        bp++;
        ct = 8;
      }
    }
    ct--;
    return (c >> ct) & 1;
  }
};

// flags of a code-block sample
constexpr uint8_t kSig = 1, kNeg = 2, kVisit = 4, kRefined = 8;

struct T1 {
  int w, h;
  int stride;
  std::vector<uint8_t> f;  // (w + 2) x (h + 2), a border of zeros
  std::vector<int32_t> data;
  Mq mq;
  uint32_t orient = 0;
  bool vsc = false;

  uint8_t& F(int x, int y) { return f[size_t(y + 1) * stride + x + 1]; }
  bool sig(int x, int y) { return f[size_t(y + 1) * stride + x + 1] & kSig; }
  // whether the row below (y + 1) may be seen from y
  bool south(int y) const { return !(vsc && (y & 3) == 3); }

  int neighbours(int x, int y, int* hh, int* vv, int* dd) {
    int hs = sig(x - 1, y) + sig(x + 1, y);
    int vs = sig(x, y - 1);
    int ds = sig(x - 1, y - 1) + sig(x + 1, y - 1);
    if (south(y)) {
      vs += sig(x, y + 1);
      ds += sig(x - 1, y + 1) + sig(x + 1, y + 1);
    }
    *hh = hs;
    *vv = vs;
    *dd = ds;
    return hs + vs + ds;
  }

  int zc_ctx(int x, int y) {
    int h_, v_, d_;
    neighbours(x, y, &h_, &v_, &d_);
    if (orient == 1) std::swap(h_, v_);
    if (orient == 3) {
      int hv = h_ + v_;
      if (d_ >= 3) return 8;
      if (d_ == 2) return hv >= 1 ? 7 : 6;
      if (d_ == 1) return hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
      return hv >= 2 ? 2 : (hv == 1 ? 1 : 0);
    }
    if (h_ == 2) return 8;
    if (h_ == 1) return v_ >= 1 ? 7 : (d_ >= 1 ? 6 : 5);
    if (v_ == 2) return 4;
    if (v_ == 1) return 3;
    return d_ >= 2 ? 2 : d_;
  }

  int contrib(int x, int y) {
    uint8_t v = f[size_t(y + 1) * stride + x + 1];
    if (!(v & kSig)) return 0;
    return (v & kNeg) ? -1 : 1;
  }

  // the sign's context, and the bit it is XORed with
  int sc_ctx(int x, int y, uint32_t* spb) {
    int hc = contrib(x - 1, y) + contrib(x + 1, y);
    int vc = contrib(x, y - 1) + (south(y) ? contrib(x, y + 1) : 0);
    hc = std::max(-1, std::min(1, hc));
    vc = std::max(-1, std::min(1, vc));
    static const int ctx[3][3] = {{13, 12, 11}, {10, 9, 10}, {11, 12, 13}};
    static const int xr[3][3] = {{1, 1, 1}, {1, 0, 0}, {0, 0, 0}};
    *spb = uint32_t(xr[hc + 1][vc + 1]);
    return kCtxSc + ctx[hc + 1][vc + 1] - 9;
  }

  void set_sig(int x, int y, uint32_t neg, int32_t oneplushalf) {
    data[size_t(y) * w + x] = neg ? -oneplushalf : oneplushalf;
    F(x, y) |= uint8_t(kSig | (neg ? kNeg : 0));
  }

  void sigpass(int32_t bpno, bool raw) {
    int32_t one = int32_t(1u << bpno), half = one >> 1;
    int32_t oneplushalf = one | half;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < k + 4 && y < h; ++y) {
          uint8_t fl = F(x, y);
          if (fl & (kSig | kVisit)) continue;
          int a_, b_, c_;
          if (!neighbours(x, y, &a_, &b_, &c_)) continue;
          if (raw) {
            if (mq.raw()) set_sig(x, y, mq.raw(), oneplushalf);
          } else if (mq.decode(kCtxZc + zc_ctx(x, y))) {
            uint32_t spb;
            int cx = sc_ctx(x, y, &spb);
            set_sig(x, y, mq.decode(cx) ^ spb, oneplushalf);
          }
          F(x, y) |= kVisit;
        }
  }

  void refpass(int32_t bpno, bool raw) {
    int32_t poshalf = int32_t(1u << bpno) >> 1;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < k + 4 && y < h; ++y) {
          uint8_t fl = F(x, y);
          if ((fl & (kSig | kVisit)) != kSig) continue;
          uint32_t v;
          if (raw) {
            v = mq.raw();
          } else {
            int a_, b_, c_;
            int cx = (fl & kRefined) ? kCtxMag + 2
                     : neighbours(x, y, &a_, &b_, &c_) ? kCtxMag + 1
                                                       : kCtxMag;
            v = mq.decode(cx);
          }
          int32_t& d = data[size_t(y) * w + x];
          d += (v ^ uint32_t(d < 0)) ? poshalf : -poshalf;
          F(x, y) |= kRefined;
        }
  }

  void clnpass(int32_t bpno, bool segsym) {
    int32_t one = int32_t(1u << bpno), half = one >> 1;
    int32_t oneplushalf = one | half;
    auto step = [&](int x, int y, bool partial) {
      if (!partial && !mq.decode(kCtxZc + zc_ctx(x, y))) return;
      uint32_t spb;
      int cx = sc_ctx(x, y, &spb);
      set_sig(x, y, mq.decode(cx) ^ spb, oneplushalf);
    };
    int k = 0;
    for (; k + 4 <= h; k += 4)
      for (int x = 0; x < w; ++x) {
        bool run = true;
        for (int y = k; y < k + 4 && run; ++y) {
          int a_, b_, c_;
          if ((F(x, y) & (kSig | kVisit)) || neighbours(x, y, &a_, &b_, &c_))
            run = false;
        }
        if (run) {
          if (!mq.decode(kCtxAgg)) continue;
          uint32_t r = mq.decode(kCtxUni);
          r = (r << 1) | mq.decode(kCtxUni);
          step(x, k + int(r), true);
          for (int y = k + int(r) + 1; y < k + 4; ++y) step(x, y, false);
        } else {
          for (int y = k; y < k + 4; ++y)
            if (!(F(x, y) & (kSig | kVisit))) step(x, y, false);
        }
      }
    if (k < h)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < h; ++y)
          if (!(F(x, y) & (kSig | kVisit))) step(x, y, false);
    for (auto& v : f) v &= uint8_t(~kVisit);
    if (segsym) {
      uint32_t v = mq.decode(kCtxUni);
      v = (v << 1) | mq.decode(kCtxUni);
      v = (v << 1) | mq.decode(kCtxUni);
      v = (v << 1) | mq.decode(kCtxUni);
      (void)v;
    }
  }

  void decode(const Cblk& cb, const uint8_t* tile_data, uint32_t orient_,
              int32_t roishift, uint32_t cblksty) {
    w = int(cb.x1 - cb.x0);
    h = int(cb.y1 - cb.y0);
    stride = w + 2;
    f.assign(size_t(w + 2) * (h + 2), 0);
    data.assign(size_t(w) * h, 0);
    orient = orient_;
    vsc = cblksty & kVsc;
    int32_t bpno_plus_one = int32_t(uint32_t(roishift) + cb.numbps);
    if (bpno_plus_one >= 31)
      refuse("a JPEG 2000 code-block of 31 bit-planes or more");
    uint32_t passtype = 2;
    mq.reset_states();
    std::vector<uint8_t> cdata;
    for (auto& ch : cb.chunks)
      cdata.insert(cdata.end(), tile_data + ch.first,
                   tile_data + ch.first + ch.second);
    size_t index = 0;
    for (uint32_t segno = 0; segno < cb.real_num_segs; ++segno) {
      const Seg& seg = cb.segs[segno];
      bool raw = bpno_plus_one <= int32_t(cb.numbps) - 4 && passtype < 2 &&
                 (cblksty & kLazy);
      const uint8_t* p = cdata.data() + index;
      if (raw) mq.raw_init_dec(p, seg.len);
      else mq.init_dec(p, seg.len);
      index += seg.len;
      for (uint32_t passno = 0;
           passno < seg.real_num_passes && bpno_plus_one >= 1; ++passno) {
        switch (passtype) {
          case 0: sigpass(bpno_plus_one, raw); break;
          case 1: refpass(bpno_plus_one, raw); break;
          case 2: clnpass(bpno_plus_one, cblksty & kSegSym); break;
        }
        if ((cblksty & kReset) && !raw) mq.reset_states();
        if (++passtype == 3) {
          passtype = 0;
          bpno_plus_one--;
        }
      }
    }
  }
};

// ----------------------------------------------------------- the wavelet

inline int32_t wrap_add(int32_t a, int32_t b) {
  return int32_t(uint32_t(a) + uint32_t(b));
}

// one 5/3 signal, interleaved in place: `sn` low and `dn` high samples as
// [low..., high...] in `x`, the first at an even coordinate where cas == 0
void idwt53(int32_t* x, int sn, int dn, int cas, std::vector<int32_t>& tmp) {
  int len = sn + dn;
  if (cas == 0) {
    if (len <= 1) return;
  } else {
    if (len == 1) {
      x[0] /= 2;
      return;
    }
  }
  tmp.assign(size_t(len), 0);
  // interleave
  for (int i = 0; i < sn; ++i) tmp[size_t(cas + 2 * i)] = x[i];
  for (int i = 0; i < dn; ++i) tmp[size_t(1 - cas + 2 * i)] = x[sn + i];
  auto at = [&](int i) -> int32_t {
    // symmetric extension
    if (i < 0) i = -i;
    if (i >= len) i = 2 * (len - 1) - i;
    return tmp[size_t(i)];
  };
  // even coordinates (low): X -= floor((left + right + 2) / 4)
  for (int i = cas; i < len; i += 2)
    tmp[size_t(i)] = int32_t(uint32_t(tmp[size_t(i)]) -
                             uint32_t(wrap_add(wrap_add(at(i - 1), at(i + 1)), 2) >> 2));
  // odd coordinates (high): X += floor((left + right) / 2)
  for (int i = 1 - cas; i < len; i += 2)
    tmp[size_t(i)] = wrap_add(tmp[size_t(i)], wrap_add(at(i - 1), at(i + 1)) >> 1);
  std::memcpy(x, tmp.data(), size_t(len) * sizeof(int32_t));
}

constexpr float kAlpha = -1.586134342f, kBeta = -0.052980118f,
                kGamma = 0.882911075f, kDelta = 0.443506852f,
                kK = 1.230174105f, kTwoInvK = 1.625732422f;

// openjpeg's lifting step over interleaved samples w[0 .. len): the
// samples at `target + 2i` take c * (their two neighbours)
void lift(float* w, int first_nb, int target, int end, int m, float c) {
  // openjpeg's opj_v8dwt_decode_step2 with l = w + first_nb and
  // fw = w + target + 1
  float* fl = w + first_nb;
  float* fw = w + target + 1;
  int imax = std::min(end, m);
  for (int i = 0; i < imax; ++i) {
    fw[-1] = fw[-1] + (fl[0] + fw[0]) * c;
    fl = fw;
    fw += 2;
  }
  if (m < end) {
    float c2 = c + c;
    fw[-1] = fw[-1] + fl[0] * c2;
  }
}

void idwt97(float* w, int sn, int dn, int cas) {
  int a, b;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
    a = 0;
    b = 1;
  } else {
    if (!(sn > 0 || dn > 1)) return;
    a = 1;
    b = 0;
  }
  for (int i = 0; i < sn; ++i) w[a + 2 * i] *= kK;
  for (int i = 0; i < dn; ++i) w[b + 2 * i] *= kTwoInvK;
  lift(w, b, a, sn, std::min(sn, dn - a), -kDelta);
  lift(w, a, b, dn, std::min(dn, sn - b), -kGamma);
  lift(w, b, a, sn, std::min(sn, dn - a), -kBeta);
  lift(w, a, b, dn, std::min(dn, sn - b), -kAlpha);
}

inline float fbits(uint32_t v) {
  float f;
  std::memcpy(&f, &v, 4);
  return f;
}
inline uint32_t bitsf(float f) {
  uint32_t v;
  std::memcpy(&v, &f, 4);
  return v;
}

void dwt_decode(TileComp& tc, uint32_t numres, bool real) {
  if (numres <= 1) return;
  int64_t w = tc.x1 - tc.x0;
  int rw = int(tc.res[0].x1 - tc.res[0].x0);
  int rh = int(tc.res[0].y1 - tc.res[0].y0);
  std::vector<int32_t> tmp;
  std::vector<int32_t> line;
  std::vector<float> fline;
  for (uint32_t r = 1; r < numres; ++r) {
    const Res& res = tc.res[r];
    int hsn = rw, vsn = rh;
    rw = int(res.x1 - res.x0);
    rh = int(res.y1 - res.y0);
    int hdn = rw - hsn, vdn = rh - vsn;
    int hcas = int(res.x0 % 2), vcas = int(res.y0 % 2);
    // rows
    for (int j = 0; j < rh; ++j) {
      uint32_t* row = tc.data.data() + size_t(j) * w;
      if (real) {
        fline.assign(size_t(rw), 0.f);
        for (int i = 0; i < hsn; ++i) fline[size_t(hcas + 2 * i)] = fbits(row[i]);
        for (int i = 0; i < hdn; ++i)
          fline[size_t(1 - hcas + 2 * i)] = fbits(row[hsn + i]);
        idwt97(fline.data(), hsn, hdn, hcas);
        for (int i = 0; i < rw; ++i) row[i] = bitsf(fline[size_t(i)]);
      } else {
        line.assign(row, row + rw);
        idwt53(line.data(), hsn, hdn, hcas, tmp);
        std::memcpy(row, line.data(), size_t(rw) * 4);
      }
    }
    // columns
    for (int i = 0; i < rw; ++i) {
      uint32_t* col = tc.data.data() + i;
      if (real) {
        fline.assign(size_t(rh), 0.f);
        for (int j = 0; j < vsn; ++j)
          fline[size_t(vcas + 2 * j)] = fbits(col[size_t(j) * w]);
        for (int j = 0; j < vdn; ++j)
          fline[size_t(1 - vcas + 2 * j)] = fbits(col[size_t(vsn + j) * w]);
        idwt97(fline.data(), vsn, vdn, vcas);
        for (int j = 0; j < rh; ++j) col[size_t(j) * w] = bitsf(fline[size_t(j)]);
      } else {
        line.resize(size_t(rh));
        for (int j = 0; j < rh; ++j) line[size_t(j)] = int32_t(col[size_t(j) * w]);
        idwt53(line.data(), vsn, vdn, vcas, tmp);
        for (int j = 0; j < rh; ++j) col[size_t(j) * w] = uint32_t(line[size_t(j)]);
      }
    }
  }
}

// --------------------------------------------------------- a whole tile

struct TileDecoder {
  Codestream& cs;
  int tileno;
  Tcp& tcp;
  int64_t tx0, ty0, tx1, ty1;
  std::vector<TileComp> tcs;

  TileDecoder(Codestream& c, int t) : cs(c), tileno(t), tcp(c.tcps[t]) {}

  void init() {
    uint32_t p = uint32_t(tileno) % cs.tw, q = uint32_t(tileno) / cs.tw;
    tx0 = std::max(cs.tx0 + p * cs.tdx, cs.X0);
    ty0 = std::max(cs.ty0 + q * cs.tdy, cs.Y0);
    tx1 = std::min(cs.tx0 + (p + 1) * cs.tdx, cs.X1);
    ty1 = std::min(cs.ty0 + (q + 1) * cs.tdy, cs.Y1);
    size_t nc = cs.comps.size();
    tcs.resize(nc);
    for (size_t c = 0; c < nc; ++c) {
      const Comp& comp = cs.comps[c];
      const Tccp& tccp = tcp.tccps[c];
      TileComp& tc = tcs[c];
      tc.x0 = ceildiv(tx0, comp.dx);
      tc.y0 = ceildiv(ty0, comp.dy);
      tc.x1 = ceildiv(tx1, comp.dx);
      tc.y1 = ceildiv(ty1, comp.dy);
      tc.numres = tccp.numres;
      tc.res.resize(tc.numres);
      int64_t tw_ = tc.x1 - tc.x0, th_ = tc.y1 - tc.y0;
      if (tw_ * th_ > (int64_t(1) << 30))
        refuse("a JPEG 2000 tile past the size limit");
      tc.data.assign(size_t(tw_ * th_), 0);
      size_t stepno = 0;
      for (uint32_t resno = 0; resno < tc.numres; ++resno) {
        Res& res = tc.res[resno];
        int level = int(tc.numres - 1 - resno);
        res.x0 = ceildivpow2(tc.x0, level);
        res.y0 = ceildivpow2(tc.y0, level);
        res.x1 = ceildivpow2(tc.x1, level);
        res.y1 = ceildivpow2(tc.y1, level);
        uint32_t pdx = tccp.prcw[resno], pdy = tccp.prch[resno];
        res.pdx = pdx;
        res.pdy = pdy;
        int64_t tlpx = floordivpow2(res.x0, int(pdx)) << pdx;
        int64_t tlpy = floordivpow2(res.y0, int(pdy)) << pdy;
        int64_t brpx = ceildivpow2(res.x1, int(pdx)) << pdx;
        int64_t brpy = ceildivpow2(res.y1, int(pdy)) << pdy;
        res.pw = res.x0 == res.x1 ? 0 : uint32_t((brpx - tlpx) >> pdx);
        res.ph = res.y0 == res.y1 ? 0 : uint32_t((brpy - tlpy) >> pdy);
        if (uint64_t(res.pw) * res.ph > (uint64_t(1) << 26))
          refuse("a JPEG 2000 precinct count past the size limit");
        int64_t tlcbgx, tlcbgy;
        uint32_t cbgw, cbgh;
        if (resno == 0) {
          tlcbgx = tlpx;
          tlcbgy = tlpy;
          cbgw = pdx;
          cbgh = pdy;
          res.numbands = 1;
        } else {
          tlcbgx = ceildivpow2(tlpx, 1);
          tlcbgy = ceildivpow2(tlpy, 1);
          cbgw = pdx - 1;
          cbgh = pdy - 1;
          res.numbands = 3;
        }
        uint32_t cbw = std::min(tccp.cblkw, cbgw);
        uint32_t cbh = std::min(tccp.cblkh, cbgh);
        for (uint32_t bandno = 0; bandno < res.numbands; ++bandno, ++stepno) {
          Band& band = res.bands[bandno];
          if (resno == 0) {
            band.bandno = 0;
            band.x0 = ceildivpow2(tc.x0, level);
            band.y0 = ceildivpow2(tc.y0, level);
            band.x1 = ceildivpow2(tc.x1, level);
            band.y1 = ceildivpow2(tc.y1, level);
          } else {
            band.bandno = bandno + 1;
            int64_t x0b = band.bandno & 1, y0b = band.bandno >> 1;
            band.x0 = ceildivpow2(tc.x0 - (x0b << level), level + 1);
            band.y0 = ceildivpow2(tc.y0 - (y0b << level), level + 1);
            band.x1 = ceildivpow2(tc.x1 - (x0b << level), level + 1);
            band.y1 = ceildivpow2(tc.y1 - (y0b << level), level + 1);
          }
          const StepSize& ss = tccp.steps[stepno < kMaxBands ? stepno : 0];
          int32_t gain = tccp.qmfbid == 0 ? 0
                         : band.bandno == 0 ? 0
                         : band.bandno == 3 ? 2 : 1;
          int32_t rb = int32_t(comp.prec) + gain;
          band.stepsize = float((1.0 + ss.mant / 2048.0) *
                                std::pow(2.0, double(rb - ss.expn)));
          band.numbps = ss.expn + int32_t(tccp.numgbits) - 1;
          band.precs.resize(size_t(res.pw) * res.ph);
          band.coef.assign(size_t((band.x1 - band.x0) * (band.y1 - band.y0)), 0);
          for (uint32_t precno = 0; precno < res.pw * res.ph; ++precno) {
            Prec& pr = band.precs[precno];
            int64_t cx0 = tlcbgx + int64_t(precno % res.pw) * (int64_t(1) << cbgw);
            int64_t cy0 = tlcbgy + int64_t(precno / res.pw) * (int64_t(1) << cbgh);
            pr.x0 = std::max(cx0, band.x0);
            pr.y0 = std::max(cy0, band.y0);
            pr.x1 = std::min(cx0 + (int64_t(1) << cbgw), band.x1);
            pr.y1 = std::min(cy0 + (int64_t(1) << cbgh), band.y1);
            int64_t tlcx = floordivpow2(pr.x0, int(cbw)) << cbw;
            int64_t tlcy = floordivpow2(pr.y0, int(cbh)) << cbh;
            int64_t brcx = ceildivpow2(pr.x1, int(cbw)) << cbw;
            int64_t brcy = ceildivpow2(pr.y1, int(cbh)) << cbh;
            int64_t cw = (brcx - tlcx) >> cbw, ch = (brcy - tlcy) >> cbh;
            pr.cw = cw > 0 ? uint32_t(cw) : 0;
            pr.ch = ch > 0 ? uint32_t(ch) : 0;
            pr.cblks.resize(size_t(pr.cw) * pr.ch);
            for (uint32_t k = 0; k < pr.cw * pr.ch; ++k) {
              Cblk& cb = pr.cblks[k];
              int64_t bx = tlcx + int64_t(k % pr.cw) * (int64_t(1) << cbw);
              int64_t by = tlcy + int64_t(k / pr.cw) * (int64_t(1) << cbh);
              cb.x0 = std::max(bx, pr.x0);
              cb.y0 = std::max(by, pr.y0);
              cb.x1 = std::min(bx + (int64_t(1) << cbw), pr.x1);
              cb.y1 = std::min(by + (int64_t(1) << cbh), pr.y1);
            }
            pr.incl.create(pr.cw, pr.ch);
            pr.imsb.create(pr.cw, pr.ch);
          }
        }
      }
    }
  }

  // ---- the packet order (openjpeg's pi.c)

  std::vector<Packet> packets() {
    std::vector<Packet> out;
    size_t nc = tcs.size();
    uint32_t max_res = 0, max_prec = 0;
    for (auto& tc : tcs) {
      max_res = std::max(max_res, tc.numres);
      for (auto& r : tc.res) max_prec = std::max(max_prec, r.pw * r.ph);
    }
    uint64_t step_c = max_prec, step_r = nc * step_c, step_l = max_res * step_r;
    std::vector<uint8_t> include(size_t((tcp.numlayers + 1) * step_l), 0);
    std::vector<Poc> entries;
    if (tcp.poc) {
      entries = tcp.pocs;
    } else {
      entries.push_back(Poc{0, 0, tcp.numlayers, max_res, uint32_t(nc), tcp.prg});
    }
    auto emit = [&](uint32_t l, uint32_t r, uint32_t c, uint32_t p) {
      uint64_t index = l * step_l + r * step_r + c * step_c + p;
      if (index >= include.size())
        refuse("a JPEG 2000 packet past the progression's bounds");
      if (!include[index]) {
        include[index] = 1;
        out.push_back(Packet{l, r, c, p});
      }
    };
    for (const Poc& poc : entries) {
      if (poc.prg == 0xffffffff)
        refuse("a JPEG 2000 progression order past CPRL");
      if (poc.compno0 >= nc || poc.compno1 >= nc + 1) continue;
      uint32_t l1 = poc.layno1;
      switch (poc.prg) {
        case 0:  // LRCP
          for (uint32_t l = 0; l < l1; ++l)
            for (uint32_t r = poc.resno0; r < poc.resno1; ++r)
              for (uint32_t c = poc.compno0; c < poc.compno1; ++c) {
                if (r >= tcs[c].numres) continue;
                const Res& res = tcs[c].res[r];
                for (uint32_t p = 0; p < res.pw * res.ph; ++p) emit(l, r, c, p);
              }
          break;
        case 1:  // RLCP
          for (uint32_t r = poc.resno0; r < poc.resno1; ++r)
            for (uint32_t l = 0; l < l1; ++l)
              for (uint32_t c = poc.compno0; c < poc.compno1; ++c) {
                if (r >= tcs[c].numres) continue;
                const Res& res = tcs[c].res[r];
                for (uint32_t p = 0; p < res.pw * res.ph; ++p) emit(l, r, c, p);
              }
          break;
        case 2: case 3: case 4:
          position_order(poc, emit);
          break;
        default:
          break;
      }
    }
    return out;
  }

  // the precinct at reference-grid position (x, y) of component c,
  // resolution r, or -1
  int64_t precinct_at(uint32_t c, uint32_t r, uint64_t x, uint64_t y) {
    const Comp& comp = cs.comps[c];
    const TileComp& tc = tcs[c];
    if (r >= tc.numres) return -1;
    const Res& res = tc.res[r];
    uint32_t levelno = tc.numres - 1 - r;
    uint64_t cdx = uint64_t(comp.dx) << levelno, cdy = uint64_t(comp.dy) << levelno;
    if (levelno >= 32 || cdx > 0xffffffffULL || cdy > 0xffffffffULL) return -1;
    uint64_t trx0 = ceildiv(tx0, int64_t(cdx)), try0 = ceildiv(ty0, int64_t(cdy));
    uint64_t trx1 = ceildiv(tx1, int64_t(cdx)), try1 = ceildiv(ty1, int64_t(cdy));
    uint32_t rpx = res.pdx + levelno, rpy = res.pdy + levelno;
    if (rpx >= 32 || rpy >= 32 ||
        (uint64_t(comp.dx) << rpx) > 0xffffffffULL ||
        (uint64_t(comp.dy) << rpy) > 0xffffffffULL)
      return -1;
    if (!((y % (uint64_t(comp.dy) << rpy) == 0) ||
          (y == uint64_t(ty0) && ((try0 << levelno) % (uint64_t(1) << rpy)))))
      return -1;
    if (!((x % (uint64_t(comp.dx) << rpx) == 0) ||
          (x == uint64_t(tx0) && ((trx0 << levelno) % (uint64_t(1) << rpx)))))
      return -1;
    if (res.pw == 0 || res.ph == 0) return -1;
    if (trx0 == trx1 || try0 == try1) return -1;
    uint64_t prci = (ceildiv(int64_t(x), int64_t(cdx)) >> res.pdx) - (trx0 >> res.pdx);
    uint64_t prcj = (ceildiv(int64_t(y), int64_t(cdy)) >> res.pdy) - (try0 >> res.pdy);
    return int64_t(prci + prcj * res.pw);
  }

  // the least step of precincts on the reference grid over components
  // [c0, c1)
  bool steps(uint32_t c0, uint32_t c1, uint64_t* dx, uint64_t* dy) {
    *dx = *dy = 0;
    for (uint32_t c = c0; c < c1; ++c) {
      const Comp& comp = cs.comps[c];
      const TileComp& tc = tcs[c];
      for (uint32_t r = 0; r < tc.numres; ++r) {
        const Res& res = tc.res[r];
        uint32_t sx = res.pdx + tc.numres - 1 - r, sy = res.pdy + tc.numres - 1 - r;
        if (sx < 32 && comp.dx <= 0xffffffffu / (1u << sx)) {
          uint64_t v = uint64_t(comp.dx) << sx;
          *dx = *dx ? std::min(*dx, v) : v;
        }
        if (sy < 32 && comp.dy <= 0xffffffffu / (1u << sy)) {
          uint64_t v = uint64_t(comp.dy) << sy;
          *dy = *dy ? std::min(*dy, v) : v;
        }
      }
    }
    return *dx && *dy;
  }

  template <class Emit>
  void position_order(const Poc& poc, Emit& emit) {
    uint64_t dx, dy;
    uint64_t x0 = uint64_t(tx0), y0 = uint64_t(ty0), x1 = uint64_t(tx1),
             y1 = uint64_t(ty1);
    auto layers = [&](uint32_t r, uint32_t c, int64_t p) {
      if (p < 0) return;
      for (uint32_t l = 0; l < poc.layno1; ++l) emit(l, r, c, uint32_t(p));
    };
    if (poc.prg == 2) {  // RPCL
      if (!steps(0, uint32_t(tcs.size()), &dx, &dy)) return;
      for (uint32_t r = poc.resno0; r < poc.resno1; ++r)
        for (uint64_t y = y0; y < y1; y += dy - (y % dy))
          for (uint64_t x = x0; x < x1; x += dx - (x % dx))
            for (uint32_t c = poc.compno0; c < poc.compno1; ++c)
              layers(r, c, precinct_at(c, r, x, y));
    } else if (poc.prg == 3) {  // PCRL
      if (!steps(0, uint32_t(tcs.size()), &dx, &dy)) return;
      for (uint64_t y = y0; y < y1; y += dy - (y % dy))
        for (uint64_t x = x0; x < x1; x += dx - (x % dx))
          for (uint32_t c = poc.compno0; c < poc.compno1; ++c) {
            uint32_t rend = std::min(poc.resno1, tcs[c].numres);
            for (uint32_t r = poc.resno0; r < rend; ++r)
              layers(r, c, precinct_at(c, r, x, y));
          }
    } else {  // CPRL
      for (uint32_t c = poc.compno0; c < poc.compno1; ++c) {
        if (!steps(c, c + 1, &dx, &dy)) return;
        for (uint64_t y = y0; y < y1; y += dy - (y % dy))
          for (uint64_t x = x0; x < x1; x += dx - (x % dx)) {
            uint32_t rend = std::min(poc.resno1, tcs[c].numres);
            for (uint32_t r = poc.resno0; r < rend; ++r)
              layers(r, c, precinct_at(c, r, x, y));
          }
      }
    }
  }

  // ---- tier 2

  // openjpeg's opj_tcd_is_subband_area_of_interest over the whole tile
  bool of_interest(uint32_t c, uint32_t resno, uint32_t bandno,
                   const Prec& pr) {
    const TileComp& tc = tcs[c];
    uint32_t margin = tcp.tccps[c].qmfbid == 1 ? 2 : 3;
    uint64_t tcx0 = uint64_t(tc.x0), tcy0 = uint64_t(tc.y0),
             tcx1 = uint64_t(tc.x1), tcy1 = uint64_t(tc.y1);
    uint32_t nb = resno == 0 ? tc.numres - 1 : tc.numres - resno;
    uint32_t x0b = bandno & 1, y0b = bandno >> 1;
    auto map = [&](uint64_t v, uint32_t b) -> uint64_t {
      if (nb == 0) return v;
      uint64_t off = (uint64_t(1) << (nb - 1)) * b;
      if (v <= off) return 0;
      return (v - off + (uint64_t(1) << nb) - 1) >> nb;
    };
    uint64_t bx0 = map(tcx0, x0b), by0 = map(tcy0, y0b);
    uint64_t bx1 = map(tcx1, x0b), by1 = map(tcy1, y0b);
    bx0 = bx0 < margin ? 0 : bx0 - margin;
    by0 = by0 < margin ? 0 : by0 - margin;
    bx1 = std::min<uint64_t>(bx1 + margin, 0xffffffffULL);
    by1 = std::min<uint64_t>(by1 + margin, 0xffffffffULL);
    uint64_t px0 = uint32_t(pr.x0), py0 = uint32_t(pr.y0),
             px1 = uint32_t(pr.x1), py1 = uint32_t(pr.y1);
    return px0 < bx1 && py0 < by1 && px1 > bx0 && py1 > by0;
  }

  void t2() {
    const uint8_t* src = tcp.data.data();
    size_t max_len = tcp.data.size();
    size_t pos = 0;
    if (tcp.ppt) {
      tcp.ppt_data.clear();
      for (size_t i = 0; i < tcp.ppt_markers.size(); ++i)
        if (tcp.ppt_seen[i])
          tcp.ppt_data.insert(tcp.ppt_data.end(), tcp.ppt_markers[i].begin(),
                              tcp.ppt_markers[i].end());
    }
    size_t ppt_pos = 0;
    std::vector<bool> first_pass_failed(tcs.size(), true);
    for (const Packet& pk : packets()) {
      TileComp& tc = tcs[pk.compno];
      Res& res = tc.res[pk.resno];
      bool skip = true;
      for (uint32_t b = 0; b < res.numbands; ++b) {
        Band& band = res.bands[b];
        if (pk.precno < band.precs.size() &&
            of_interest(pk.compno, pk.resno, band.bandno, band.precs[pk.precno]))
          skip = false;
      }
      size_t used = read_packet(pk, src + pos, max_len - pos, ppt_pos, pos);
      if (!skip) {
        first_pass_failed[pk.compno] = false;
        Comp& comp = cs.comps[pk.compno];
        comp.resno_decoded = std::max(comp.resno_decoded, pk.resno);
      }
      if (first_pass_failed[pk.compno]) {
        Comp& comp = cs.comps[pk.compno];
        if (comp.resno_decoded == 0) comp.resno_decoded = tc.numres - 1;
      }
      pos += used;
    }
  }

  // one packet: its header (from src, PPT or PPM) and its body; the bytes
  // of src it takes
  size_t read_packet(const Packet& pk, const uint8_t* src, size_t max_len,
                     size_t& ppt_pos, size_t base) {
    TileComp& tc = tcs[pk.compno];
    Res& res = tc.res[pk.resno];
    const Tccp& tccp = tcp.tccps[pk.compno];
    if (pk.layno == 0)
      for (uint32_t b = 0; b < res.numbands; ++b) {
        Band& band = res.bands[b];
        if (band.empty()) continue;
        if (pk.precno >= band.precs.size())
          refuse("a JPEG 2000 packet for no precinct");
        Prec& pr = band.precs[pk.precno];
        pr.incl.reset();
        pr.imsb.reset();
        for (auto& cb : pr.cblks) {
          cb.numsegs = 0;
          cb.real_num_segs = 0;
        }
      }
    const uint8_t* cur = src;
    if (tcp.csty & kCspSop) {
      if (max_len >= 6 && cur[0] == 0xff && cur[1] == 0x91) cur += 6;
    }
    // the header's bytes
    const uint8_t* hdr;
    size_t hdr_len;
    if (cs.ppm) {
      hdr = cs.ppm_data.data() + cs.ppm_pos;
      hdr_len = cs.ppm_data.size() - cs.ppm_pos;
    } else if (tcp.ppt) {
      hdr = tcp.ppt_data.data() + ppt_pos;
      hdr_len = tcp.ppt_data.size() - ppt_pos;
    } else {
      hdr = cur;
      hdr_len = size_t(src + max_len - cur);
    }
    Bio bio(hdr, hdr_len);
    bool present = bio.read(1);
    if (present) {
      for (uint32_t b = 0; b < res.numbands; ++b) {
        Band& band = res.bands[b];
        if (band.empty()) continue;
        Prec& pr = band.precs[pk.precno];
        for (uint32_t k = 0; k < pr.cblks.size(); ++k) {
          Cblk& cb = pr.cblks[k];
          uint32_t included;
          if (!cb.numsegs)
            included = pr.incl.decode(bio, k, int32_t(pk.layno + 1));
          else
            included = bio.read(1);
          if (!included) {
            cb.numnewpasses = 0;
            continue;
          }
          if (!cb.numsegs) {
            uint32_t i = 0;
            while (!pr.imsb.decode(bio, k, int32_t(i))) ++i;
            cb.numbps = uint32_t(band.numbps) + 1 - i;
            cb.numlenbits = 3;
          }
          cb.numnewpasses = getnumpasses(bio);
          uint32_t inc = 0;
          while (bio.read(1)) ++inc;
          cb.numlenbits += inc;
          uint32_t segno = 0;
          if (!cb.numsegs) {
            init_seg(cb, 0, tccp.cblksty, true);
          } else {
            segno = cb.numsegs - 1;
            if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
              ++segno;
              init_seg(cb, segno, tccp.cblksty, false);
            }
          }
          int32_t n = int32_t(cb.numnewpasses);
          do {
            Seg& s = cb.segs[segno];
            s.numnewpasses = uint32_t(std::min<int64_t>(
                int64_t(s.maxpasses) - int64_t(s.numpasses), n));
            uint32_t bits = cb.numlenbits + floorlog2(s.numnewpasses);
            if (bits > 32) refuse("a JPEG 2000 segment length of over 32 bits");
            s.newlen = bio.read(bits);
            n -= int32_t(s.numnewpasses);
            if (n > 0) {
              ++segno;
              init_seg(cb, segno, tccp.cblksty, false);
            }
          } while (n > 0);
        }
      }
    }
    bio.inalign();
    const uint8_t* hend = hdr + bio.numbytes();
    if (tcp.csty & kCspEph) {
      if (size_t(hdr + hdr_len - hend) < 2 || hend[0] != 0xff ||
          hend[1] != 0x92)
        refuse("a JPEG 2000 packet header without its EPH marker");
      hend += 2;
    }
    size_t hlen = size_t(hend - hdr);
    if (cs.ppm) cs.ppm_pos += hlen;
    else if (tcp.ppt) ppt_pos += hlen;
    else cur += hlen;
    if (!present) return size_t(cur - src);
    // the body
    for (uint32_t b = 0; b < res.numbands; ++b) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      Prec& pr = band.precs[pk.precno];
      for (auto& cb : pr.cblks) {
        if (!cb.numnewpasses) continue;
        uint32_t segi;
        if (!cb.numsegs) {
          segi = 0;
          ++cb.numsegs;
        } else {
          segi = cb.numsegs - 1;
          if (cb.segs[segi].numpasses == cb.segs[segi].maxpasses) {
            ++segi;
            ++cb.numsegs;
          }
        }
        do {
          Seg& s = cb.segs[segi];
          if (size_t(cur - src) + s.newlen > max_len)
            refuse("a JPEG 2000 code-block segment past its tile-part");
          cb.chunks.emplace_back(base + size_t(cur - src), s.newlen);
          cur += s.newlen;
          s.len += s.newlen;
          s.numpasses += s.numnewpasses;
          cb.numnewpasses -= s.numnewpasses;
          s.real_num_passes = s.numpasses;
          if (cb.numnewpasses > 0) {
            ++segi;
            ++cb.numsegs;
          }
        } while (cb.numnewpasses > 0);
        cb.real_num_segs = cb.numsegs;
      }
    }
    return size_t(cur - src);
  }

  // ---- tier 1 into the sub-band planes, then the tile-component buffer

  void t1() {
    T1 t1;
    for (size_t c = 0; c < tcs.size(); ++c) {
      TileComp& tc = tcs[c];
      const Tccp& tccp = tcp.tccps[c];
      for (uint32_t r = 0; r < tc.numres; ++r) {
        Res& res = tc.res[r];
        for (uint32_t b = 0; b < res.numbands; ++b) {
          Band& band = res.bands[b];
          int64_t bw = band.x1 - band.x0;
          for (auto& pr : band.precs)
            for (auto& cb : pr.cblks) {
              t1.decode(cb, tcp.data.data(), band.bandno, tccp.roishift,
                        tccp.cblksty);
              int32_t* dp = t1.data.data();
              size_t cnt = t1.data.size();
              if (tccp.roishift) {
                if (tccp.roishift >= 31) {
                  std::fill(dp, dp + cnt, 0);
                } else {
                  int32_t thresh = int32_t(1) << tccp.roishift;
                  for (size_t i = 0; i < cnt; ++i) {
                    int32_t v = dp[i];
                    int32_t mag = v < 0 ? -v : v;
                    if (mag >= thresh) {
                      mag >>= tccp.roishift;
                      dp[i] = v < 0 ? -mag : mag;
                    }
                  }
                }
              }
              int cw = t1.w, ch = t1.h;
              for (int j = 0; j < ch; ++j) {
                uint32_t* out = band.coef.data() +
                                size_t(cb.y0 - band.y0 + j) * bw +
                                (cb.x0 - band.x0);
                const int32_t* in = dp + size_t(j) * cw;
                if (tccp.qmfbid == 1) {
                  for (int i = 0; i < cw; ++i) out[i] = uint32_t(in[i] / 2);
                } else {
                  const float step = 0.5f * band.stepsize;
                  for (int i = 0; i < cw; ++i)
                    out[i] = bitsf(float(in[i]) * step);
                }
              }
            }
        }
      }
    }
  }

  // the sub-band planes into the tile-component buffer, as openjpeg lays
  // them out for its inverse wavelet
  void place() {
    for (auto& tc : tcs) {
      int64_t w = tc.x1 - tc.x0;
      for (uint32_t r = 0; r < tc.numres; ++r) {
        Res& res = tc.res[r];
        for (uint32_t b = 0; b < res.numbands; ++b) {
          Band& band = res.bands[b];
          int64_t ox = 0, oy = 0;
          if (band.bandno & 1) ox = tc.res[r - 1].x1 - tc.res[r - 1].x0;
          if (band.bandno & 2) oy = tc.res[r - 1].y1 - tc.res[r - 1].y0;
          int64_t bw = band.x1 - band.x0, bh = band.y1 - band.y0;
          for (int64_t j = 0; bw > 0 && j < bh; ++j)
            std::memcpy(tc.data.data() + size_t((oy + j) * w + ox),
                        band.coef.data() + size_t(j * bw), size_t(bw) * 4);
          std::vector<uint32_t>().swap(band.coef);
        }
      }
    }
  }

  void reconstruct(int32_t* const* planes) {
    size_t nc = tcs.size();
    for (size_t c = 0; c < nc; ++c) {
      TileComp& tc = tcs[c];
      // openjpeg rebuilds up to the highest resolution it decoded a
      // packet of; where that is smaller than the tile component, Pillow
      // unpacks stale memory. Where it is as large, the resolutions above
      // add nothing and the whole transform gives the same samples.
      uint32_t rd = std::min(cs.comps[c].resno_decoded, tc.numres - 1);
      const Res& top = tc.res[tc.numres - 1];
      if (tc.res[rd].x1 - tc.res[rd].x0 != top.x1 - top.x0 ||
          tc.res[rd].y1 - tc.res[rd].y0 != top.y1 - top.y0)
        refuse("a JPEG 2000 tile component without its top resolution");
      dwt_decode(tc, tc.numres, tcp.tccps[c].qmfbid == 0);
    }
    if (tcp.mct && nc >= 3) {
      for (int c = 1; c < 3; ++c)
        if (tcs[c].x1 - tcs[c].x0 != tcs[0].x1 - tcs[0].x0 ||
            tcs[c].y1 - tcs[c].y0 != tcs[0].y1 - tcs[0].y0 ||
            cs.comps[c].resno_decoded != cs.comps[0].resno_decoded)
          refuse("a JPEG 2000 colour transform over components of other sizes");
      size_t n = tcs[0].data.size();
      uint32_t* c0 = tcs[0].data.data();
      uint32_t* c1 = tcs[1].data.data();
      uint32_t* c2 = tcs[2].data.data();
      if (tcp.tccps[0].qmfbid == 1) {
        for (size_t i = 0; i < n; ++i) {
          int32_t y = int32_t(c0[i]), u = int32_t(c1[i]), v = int32_t(c2[i]);
          int32_t g = y - ((u + v) >> 2);
          int32_t r = v + g;
          int32_t b = u + g;
          c0[i] = uint32_t(r);
          c1[i] = uint32_t(g);
          c2[i] = uint32_t(b);
        }
      } else {
        for (size_t i = 0; i < n; ++i) {
          float y = fbits(c0[i]), u = fbits(c1[i]), v = fbits(c2[i]);
          float r = y + (v * 1.402f);
          float g = y - (u * 0.34413f) - (v * 0.71414f);
          float b = y + (u * 1.772f);
          c0[i] = bitsf(r);
          c1[i] = bitsf(g);
          c2[i] = bitsf(b);
        }
      }
    }
    for (size_t c = 0; c < nc; ++c) {
      TileComp& tc = tcs[c];
      const Comp& comp = cs.comps[c];
      int32_t lo, hi;
      if (comp.sgnd) {
        lo = -(int32_t(1) << (comp.prec - 1));
        hi = (int32_t(1) << (comp.prec - 1)) - 1;
      } else {
        lo = 0;
        hi = int32_t((1u << comp.prec) - 1);
      }
      int32_t shift = comp.sgnd ? 0 : int32_t(1) << (comp.prec - 1);
      int64_t w = tc.x1 - tc.x0, h = tc.y1 - tc.y0;
      int32_t* plane = planes[c];
      bool real = tcp.tccps[c].qmfbid == 0;
      for (int64_t j = 0; j < h; ++j) {
        int32_t* out = plane + size_t((tc.y0 - comp.y0 + j) * comp.w +
                                      (tc.x0 - comp.x0));
        const uint32_t* in = tc.data.data() + size_t(j * w);
        for (int64_t i = 0; i < w; ++i) {
          int32_t v;
          if (real) {
            float f = fbits(in[i]);
            if (f > float(INT32_MAX)) v = hi;
            else if (f < float(INT32_MIN)) v = lo;
            else {
              int64_t q = int64_t(std::lrintf(f)) + shift;
              v = int32_t(q < lo ? lo : q > hi ? hi : q);
            }
          } else {
            int32_t q = wrap_add(int32_t(in[i]), shift);
            v = q < lo ? lo : q > hi ? hi : q;
          }
          out[i] = v;
        }
      }
    }
  }

  void run(int32_t* const* planes) {
    init();
    t2();
    t1();
    place();
    reconstruct(planes);
  }
};

void put_error(char* err, int errlen, const std::string& what) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", what.c_str());
}

}  // namespace

extern "C" {

// The main header: info = [x0, y0, x1, y1, ncomps, tile x0, y0, w, h,
// tiles across, tiles down, then per component dx, dy, prec, sgnd];
// `cap` int32 slots. 0, or -1 with the cause in err.
int jp2_header(const uint8_t* data, long len, int32_t* info, int cap,
               char* err, int errlen) {
  try {
    Codestream cs;
    cs.d = data;
    cs.n = size_t(len);
    cs.parse();
    int need = 11 + 4 * int(cs.comps.size());
    if (need > cap) refuse("more JPEG 2000 components than the reader takes");
    int64_t vals[11] = {cs.X0, cs.Y0, cs.X1, cs.Y1, int64_t(cs.comps.size()),
                        cs.tx0, cs.ty0, cs.tdx, cs.tdy, cs.tw, cs.th};
    for (int i = 0; i < 11; ++i) info[i] = int32_t(uint32_t(vals[i]));
    for (size_t c = 0; c < cs.comps.size(); ++c) {
      info[11 + 4 * c] = int32_t(cs.comps[c].dx);
      info[12 + 4 * c] = int32_t(cs.comps[c].dy);
      info[13 + 4 * c] = int32_t(cs.comps[c].prec);
      info[14 + 4 * c] = int32_t(cs.comps[c].sgnd);
    }
    return 0;
  } catch (const Refusal& r) {
    put_error(err, errlen, r.what);
    return -1;
  } catch (const std::bad_alloc&) {
    put_error(err, errlen, "a JPEG 2000 image past the memory limit");
    return -1;
  }
}

// The whole codestream: each component's samples, after the DC shift and
// the clip, into planes[c] (its w x h on the component's grid); done[t]
// set to 1 for each tile decoded, in the order openjpeg decodes them
// (order[k] = the k-th tile, -1 after the last). 0, or -1 with the cause.
int jp2_decode(const uint8_t* data, long len, int32_t* const* planes,
               uint8_t* done, int32_t* order, char* err, int errlen) {
  try {
    Codestream cs;
    cs.d = data;
    cs.n = size_t(len);
    cs.parse();
    size_t k = 0;
    uint32_t t;
    while (cs.next_tile(&t)) {
      TileDecoder td(cs, int(t));
      td.run(planes);
      done[t] = 1;
      order[k++] = int32_t(t);
      cs.after_decode(t);
    }
    order[k] = -1;
    return 0;
  } catch (const Refusal& r) {
    put_error(err, errlen, r.what);
    return -1;
  } catch (const std::bad_alloc&) {
    put_error(err, errlen, "a JPEG 2000 image past the memory limit");
    return -1;
  }
}

}  // extern "C"
