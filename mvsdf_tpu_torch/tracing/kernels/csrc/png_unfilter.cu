// Undoes the row filters of PNG image data on the host, for scene loading
// (mvsdf_tpu_torch/data/png.py; its plain version is unfilter_reference
// there). No device code: it lives here to be built with the kernels.
//
// The Average and Paeth filters add to each byte a predictor from the
// decoded byte one pixel to its left, so a row is decoded byte by byte in
// order; a plain loop in C does ~1 ns a byte where numpy needs a Python
// iteration a pixel.

#include <cstdlib>

extern "C" {

// in: h rows of (1 + stride) bytes, a filter type (0-4) then the filtered
// bytes; bpp: bytes per pixel (>= 1); out: h x stride decoded bytes.
// Returns 0, or 1 + the filter type of the first row whose type is not 0-4.
int png_unfilter(const unsigned char* in, long long h, long long stride,
                 int bpp, unsigned char* out) {
  const unsigned char* prev = nullptr;
  for (long long y = 0; y < h; ++y) {
    const unsigned char* line = in + y * (stride + 1);
    const int kind = line[0];
    ++line;
    unsigned char* cur = out + y * stride;
    if (kind > 4) return 1 + kind;
    for (long long x = 0; x < stride; ++x) {
      const int a = x >= bpp ? cur[x - bpp] : 0;
      const int b = prev ? prev[x] : 0;
      const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
      int pred = 0;
      switch (kind) {
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int pa = std::abs(b - c), pb = std::abs(a - c),
                    pc = std::abs(a + b - 2 * c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: break;
      }
      cur[x] = (unsigned char)(line[x] + pred);
    }
    prev = cur;
  }
  return 0;
}

}  // extern "C"
