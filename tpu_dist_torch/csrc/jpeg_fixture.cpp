// Test-tree fixture: write an RGB u8 image as a baseline JPEG with
// libjpeg's own compressor. It exists to write synthetic ImageFolder trees
// for tests and for tools/data_rate.py on a host without PIL; no training
// or serving path calls it.
//
// Built into the same library as gather.cpp and decode.cpp
// (tpu_dist_torch/native.py), under the same libjpeg guard: without
// libjpeg, write_jpeg_fixture returns -1.

#include <cstdint>
#include <cstddef>

#if __has_include(<jpeglib.h>) && !defined(TPU_DIST_NO_JPEG)
#define TPU_DIST_HAVE_JPEG 1
#include <cstdio>
#include <jpeglib.h>
#else
#define TPU_DIST_HAVE_JPEG 0
#endif

extern "C" {

// (h, w, 3) RGB u8 -> a JPEG file at `path` with `quality` (1-100).
// Returns 0 on success, nonzero when the file cannot be opened or libjpeg
// is missing. libjpeg's default error handler exits the process on a
// compressor error; the inputs here are checked by the caller.
int write_jpeg_fixture(const uint8_t* rgb, int h, int w, int quality,
                       const char* path) {
#if !TPU_DIST_HAVE_JPEG
    (void)rgb; (void)h; (void)w; (void)quality; (void)path;
    return -1;
#else
    std::FILE* f = std::fopen(path, "wb");
    if (!f) return 1;
    jpeg_compress_struct cinfo;
    jpeg_error_mgr jerr;
    cinfo.err = jpeg_std_error(&jerr);
    jpeg_create_compress(&cinfo);
    jpeg_stdio_dest(&cinfo, f);
    cinfo.image_width = (JDIMENSION)w;
    cinfo.image_height = (JDIMENSION)h;
    cinfo.input_components = 3;
    cinfo.in_color_space = JCS_RGB;
    jpeg_set_defaults(&cinfo);
    jpeg_set_quality(&cinfo, quality, TRUE);
    jpeg_start_compress(&cinfo, TRUE);
    while (cinfo.next_scanline < cinfo.image_height) {
        JSAMPROW row = const_cast<uint8_t*>(
            rgb + (size_t)cinfo.next_scanline * w * 3);
        jpeg_write_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_compress(&cinfo);
    jpeg_destroy_compress(&cinfo);
    return std::fclose(f) == 0 ? 0 : 2;
#endif
}

}  // extern "C"
