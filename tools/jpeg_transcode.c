/* Lossless JPEG transcoder for tools/make_torch_image_fixtures.py, on the
 * system's libjpeg (libjpeg-turbo): reads a file's DCT coefficients and
 * writes them again arithmetic-coded (SOF9, or SOF10 with progressive), as
 * jpegtran -arithmetic does.
 *
 *     gcc -O2 -o jpeg_transcode tools/jpeg_transcode.c -ljpeg
 *     jpeg_transcode IN OUT [progressive] [separate] [restart N]
 *                    [restart-rows N] [dac L U K] [slots DC AC]
 *
 * progressive: libjpeg's standard progression script; separate: one
 * sequential scan a component; restart N: a restart marker every N MCUs,
 * restart-rows N every N MCU rows; dac L U K: the conditioning values of
 * every DC (L, U) and AC (K) table; slots DC AC: every component's DC and
 * AC table slots (0-15). The image library of the port never builds or
 * links this program.
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: %s IN OUT [options]\n", argv[0]);
    return 2;
  }
  FILE* in = fopen(argv[1], "rb");
  FILE* out = fopen(argv[2], "wb");
  if (!in || !out) {
    fprintf(stderr, "cannot open %s or %s\n", argv[1], argv[2]);
    return 2;
  }
  struct jpeg_decompress_struct src;
  struct jpeg_compress_struct dst;
  struct jpeg_error_mgr jsrc, jdst;
  src.err = jpeg_std_error(&jsrc);
  dst.err = jpeg_std_error(&jdst);
  jpeg_create_decompress(&src);
  jpeg_create_compress(&dst);
  jpeg_stdio_src(&src, in);
  jpeg_read_header(&src, TRUE);
  jvirt_barray_ptr* coefs = jpeg_read_coefficients(&src);
  jpeg_copy_critical_parameters(&src, &dst);
  dst.arith_code = TRUE;

  int progressive = 0, separate = 0;
  static jpeg_scan_info scans[MAX_COMPONENTS];
  for (int i = 3; i < argc; i++) {
    if (!strcmp(argv[i], "progressive")) {
      progressive = 1;
    } else if (!strcmp(argv[i], "separate")) {
      separate = 1;
    } else if (!strcmp(argv[i], "restart") && i + 1 < argc) {
      dst.restart_interval = (unsigned)atoi(argv[++i]);
    } else if (!strcmp(argv[i], "restart-rows") && i + 1 < argc) {
      dst.restart_in_rows = atoi(argv[++i]);
    } else if (!strcmp(argv[i], "dac") && i + 3 < argc) {
      int l = atoi(argv[i + 1]), u = atoi(argv[i + 2]), k = atoi(argv[i + 3]);
      for (int t = 0; t < NUM_ARITH_TBLS; t++) {
        dst.arith_dc_L[t] = (UINT8)l;
        dst.arith_dc_U[t] = (UINT8)u;
        dst.arith_ac_K[t] = (UINT8)k;
      }
      i += 3;
    } else if (!strcmp(argv[i], "slots") && i + 2 < argc) {
      for (int c = 0; c < dst.num_components; c++) {
        dst.comp_info[c].dc_tbl_no = atoi(argv[i + 1]);
        dst.comp_info[c].ac_tbl_no = atoi(argv[i + 2]);
      }
      i += 2;
    } else {
      fprintf(stderr, "unknown option %s\n", argv[i]);
      return 2;
    }
  }
  if (progressive) jpeg_simple_progression(&dst);
  if (separate) {
    for (int c = 0; c < dst.num_components; c++) {
      scans[c].comps_in_scan = 1;
      scans[c].component_index[0] = c;
      scans[c].Ss = 0;
      scans[c].Se = 63;
      scans[c].Ah = scans[c].Al = 0;
    }
    dst.scan_info = scans;
    dst.num_scans = dst.num_components;
  }
  jpeg_stdio_dest(&dst, out);
  jpeg_write_coefficients(&dst, coefs);
  jpeg_finish_compress(&dst);
  jpeg_destroy_compress(&dst);
  jpeg_finish_decompress(&src);
  jpeg_destroy_decompress(&src);
  fclose(in);
  fclose(out);
  return 0;
}
