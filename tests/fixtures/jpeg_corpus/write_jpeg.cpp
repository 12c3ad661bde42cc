// Writes one JPEG file with libjpeg's compression API, for make_corpus.py:
// the kinds Pillow does not write (progressive scan scripts of one's own,
// arithmetic coding, sampling factors 3 and 4, CMYK without an Adobe
// marker, YCCK). Built by make_corpus.py with g++ against the system's
// libjpeg-turbo headers (-ljpeg) when it rewrites the corpus; nothing
// else builds or runs it.
//
//   write_jpeg IN.raw OUT.jpg key=value ...
//
// IN.raw holds h * w * channels bytes of the input colour space, row-major.
// Keys (defaults in brackets):
//   w, h            the image size
//   in              input colour space: gray, rgb, ycc, cmyk, ycck, or
//                   unknown (then `n` components, written as they come)
//   space           the file's colour space: gray, ycc, rgb, cmyk or ycck
//                   [libjpeg's default for `in`]
//   q               quality [90]
//   samp            sampling factors per component, "HxV,HxV,..." [libjpeg's]
//   progressive     1: jpeg_simple_progression [0]
//   script          a scan script, scans separated by ';', each
//                   "c,c,...:Ss:Se:Ah:Al" (component indices)
//   arith           1: arithmetic coding [0]
//   dri             restart interval in MCUs [0]
//   rows            restart interval in MCU rows [0]
//   adobe, jfif     1 / 0: write the Adobe / JFIF marker [libjpeg's]
//   optimize        1: optimised Huffman tables [0]
//   dcl, dcu, ack   arithmetic conditioning of every table [0, 1, 5]
//   lossless        a predictor 1-7: a lossless (SOF3) file [0: none]
//   pt              the lossless point transform [0]
//
// Lossless files need libjpeg-turbo 3's jpeg_enable_lossless, which the
// system's 2.1 library lacks: make_corpus.py builds a second binary of
// this source with -DWITH_LOSSLESS against the same headers, linked to
// the libjpeg-turbo 3.1.3 that Pillow bundles (the same ABI, libjpeg
// 6.2's), whose decoder is the JAX loader's for those files.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <jpeglib.h>

#ifdef WITH_LOSSLESS
extern "C" void jpeg_enable_lossless(j_compress_ptr cinfo, int psv, int pt);
#endif

namespace {

std::string arg(int argc, char** argv, const char* key, const char* dflt) {
  const size_t n = strlen(key);
  for (int i = 3; i < argc; i++)
    if (!strncmp(argv[i], key, n) && argv[i][n] == '=') return argv[i] + n + 1;
  return dflt;
}

J_COLOR_SPACE space(const std::string& s) {
  if (s == "gray") return JCS_GRAYSCALE;
  if (s == "rgb") return JCS_RGB;
  if (s == "ycc") return JCS_YCbCr;
  if (s == "cmyk") return JCS_CMYK;
  if (s == "ycck") return JCS_YCCK;
  fprintf(stderr, "unknown colour space %s\n", s.c_str());
  exit(2);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: write_jpeg IN.raw OUT.jpg key=value ...\n");
    return 2;
  }
  const int w = atoi(arg(argc, argv, "w", "0").c_str());
  const int h = atoi(arg(argc, argv, "h", "0").c_str());
  const std::string in = arg(argc, argv, "in", "rgb");
  const int channels = in == "gray"                      ? 1
                       : in == "cmyk" || in == "ycck"    ? 4
                       : in == "unknown" ? atoi(arg(argc, argv, "n", "2").c_str())
                                                         : 3;
  std::vector<unsigned char> pixels((size_t)w * h * channels);
  FILE* f = fopen(argv[1], "rb");
  if (!f || fread(pixels.data(), 1, pixels.size(), f) != pixels.size()) {
    fprintf(stderr, "cannot read %s\n", argv[1]);
    return 1;
  }
  fclose(f);

  jpeg_compress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  FILE* out = fopen(argv[2], "wb");
  if (!out) return 1;
  jpeg_stdio_dest(&cinfo, out);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = channels;
  cinfo.in_color_space = in == "unknown" ? JCS_UNKNOWN : space(in);
  jpeg_set_defaults(&cinfo);
  // before the colour space and sampling, which it would reset
  const int psv = atoi(arg(argc, argv, "lossless", "0").c_str());
  if (psv) {
#ifdef WITH_LOSSLESS
    jpeg_enable_lossless(&cinfo, psv, atoi(arg(argc, argv, "pt", "0").c_str()));
#else
    fprintf(stderr, "lossless needs a build with -DWITH_LOSSLESS\n");
    return 2;
#endif
  }
  const std::string sp = arg(argc, argv, "space", "");
  if (!sp.empty()) jpeg_set_colorspace(&cinfo, space(sp));
  jpeg_set_quality(&cinfo, atoi(arg(argc, argv, "q", "90").c_str()), TRUE);
  const std::string samp = arg(argc, argv, "samp", "");
  for (size_t i = 0, c = 0; i < samp.size() && c < MAX_COMPONENTS; c++) {
    cinfo.comp_info[c].h_samp_factor = samp[i] - '0';
    cinfo.comp_info[c].v_samp_factor = samp[i + 2] - '0';
    i += 4;
  }
  cinfo.arith_code = atoi(arg(argc, argv, "arith", "0").c_str()) != 0;
  cinfo.optimize_coding = atoi(arg(argc, argv, "optimize", "0").c_str()) != 0;
  cinfo.restart_interval = atoi(arg(argc, argv, "dri", "0").c_str());
  cinfo.restart_in_rows = atoi(arg(argc, argv, "rows", "0").c_str());
  const std::string adobe = arg(argc, argv, "adobe", "");
  if (!adobe.empty()) cinfo.write_Adobe_marker = atoi(adobe.c_str()) != 0;
  const std::string jfif = arg(argc, argv, "jfif", "");
  if (!jfif.empty()) cinfo.write_JFIF_header = atoi(jfif.c_str()) != 0;
  for (int t = 0; t < NUM_ARITH_TBLS; t++) {
    cinfo.arith_dc_L[t] = atoi(arg(argc, argv, "dcl", "0").c_str());
    cinfo.arith_dc_U[t] = atoi(arg(argc, argv, "dcu", "1").c_str());
    cinfo.arith_ac_K[t] = atoi(arg(argc, argv, "ack", "5").c_str());
  }
  if (atoi(arg(argc, argv, "progressive", "0").c_str()))
    jpeg_simple_progression(&cinfo);
  const std::string script = arg(argc, argv, "script", "");
  std::vector<jpeg_scan_info> scans;
  if (!script.empty()) {
    const char* s = script.c_str();
    while (*s) {
      jpeg_scan_info scan;
      memset(&scan, 0, sizeof(scan));
      while (*s && *s != ':') {
        scan.component_index[scan.comps_in_scan++] = (int)strtol(s, (char**)&s,
                                                                 10);
        if (*s == ',') s++;
      }
      scan.Ss = (int)strtol(s + 1, (char**)&s, 10);
      scan.Se = (int)strtol(s + 1, (char**)&s, 10);
      scan.Ah = (int)strtol(s + 1, (char**)&s, 10);
      scan.Al = (int)strtol(s + 1, (char**)&s, 10);
      if (*s == ';') s++;
      scans.push_back(scan);
    }
    cinfo.scan_info = scans.data();
    cinfo.num_scans = (int)scans.size();
  }
  jpeg_start_compress(&cinfo, TRUE);
  const int stride = w * channels;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = pixels.data() + (size_t)cinfo.next_scanline * stride;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(out);
  return 0;
}
