// PNG row unfiltering on the host (ISO/IEC 15948, section 9): the five
// filter types None, Sub, Up, Average and Paeth, reversed in place of the
// zlib-inflated scanlines. Average and Paeth depend on the byte bpp before
// in the same row, so each row is one sequential pass. Host code only: the
// port builds it with nvcc (ops/_build.py) like its kernels, and the numpy
// version in data/png.py is its plain counterpart.
#include <cstdint>
#include <cstdlib>

extern "C" {

// raw: height rows of [filter byte, stride bytes]; out: height * stride
// bytes. Returns 0, or 1 + the index of the first row with an unknown
// filter type.
int png_unfilter(const uint8_t* raw, uint8_t* out, int height, int stride, int bpp) {
    for (int y = 0; y < height; ++y) {
        const uint8_t* in = raw + (size_t)y * (stride + 1);
        const int type = in[0];
        ++in;
        uint8_t* row = out + (size_t)y * stride;
        const uint8_t* prev = y > 0 ? row - stride : nullptr;
        switch (type) {
        case 0:
            for (int i = 0; i < stride; ++i) row[i] = in[i];
            break;
        case 1:
            for (int i = 0; i < stride; ++i)
                row[i] = (uint8_t)(in[i] + (i >= bpp ? row[i - bpp] : 0));
            break;
        case 2:
            for (int i = 0; i < stride; ++i)
                row[i] = (uint8_t)(in[i] + (prev ? prev[i] : 0));
            break;
        case 3:
            for (int i = 0; i < stride; ++i) {
                const int a = i >= bpp ? row[i - bpp] : 0;
                const int b = prev ? prev[i] : 0;
                row[i] = (uint8_t)(in[i] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (int i = 0; i < stride; ++i) {
                const int a = i >= bpp ? row[i - bpp] : 0;
                const int b = prev ? prev[i] : 0;
                const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
                const int p = a + b - c;
                const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
                const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                row[i] = (uint8_t)(in[i] + pred);
            }
            break;
        default:
            return 1 + y;
        }
    }
    return 0;
}

}  // extern "C"
