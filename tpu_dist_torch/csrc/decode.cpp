// Native JPEG decode for the port's ImageFolder host input pipeline
// (tpu_dist_torch.data.imagefolder): the JAX package's csrc/decode.cpp with
// the same code, so both decode a file to the same bytes.
//
// libjpeg from a memory buffer, with two wins over the PIL path:
//
//  1. DCT-domain scaling: libjpeg can emit 1/2, 1/4, 1/8-scale pixels
//     straight from the coefficients, so a 1500px photo headed for 224px
//     decodes ~8x fewer pixels before the bilinear pass ever runs.
//  2. The GIL is released for the whole decode (ctypes), so the loader's
//     thread pool decodes genuinely in parallel.
//
// Semantics mirror tpu_dist_torch.data.imagefolder's PIL route: resize so
// the SHORT side hits pre_short (= size*256//224, the reference's
// Resize(256) for CenterCrop(224)), bilinear, center crop to (size, size,
// 3) RGB u8. The target dims are computed from the ORIGINAL geometry so the
// result frames identically to the PIL path (resampling kernels differ by design).
//
// Builds without libjpeg too (__has_include guard): decode_available()
// reports 0 and the dataset takes the PIL route.

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <cmath>
#include <vector>

// TPU_DIST_NO_JPEG comes from tpu_dist_torch/native.py when its link probe
// fails (a header with no linkable library); __has_include covers the
// no-header case.
#if __has_include(<jpeglib.h>) && !defined(TPU_DIST_NO_JPEG)
#define TPU_DIST_HAVE_JPEG 1
#include <csetjmp>
#include <cstdio>
#include <jpeglib.h>
#else
#define TPU_DIST_HAVE_JPEG 0
#endif

namespace {

// Bilinear resize (H, W, 3) u8 -> (out_h, out_w, 3) u8, PIL-style
// half-pixel-centered sampling grid.
void resize_bilinear(const uint8_t* src, int h, int w, uint8_t* dst,
                     int out_h, int out_w) {
    const float sy = (float)h / out_h, sx = (float)w / out_w;
    for (int oy = 0; oy < out_h; ++oy) {
        float fy = (oy + 0.5f) * sy - 0.5f;
        int y0 = (int)std::floor(fy);
        float wy = fy - y0;
        int y1 = y0 + 1;
        if (y0 < 0) y0 = 0;
        if (y1 < 0) y1 = 0;
        if (y0 > h - 1) y0 = h - 1;
        if (y1 > h - 1) y1 = h - 1;
        for (int ox = 0; ox < out_w; ++ox) {
            float fx = (ox + 0.5f) * sx - 0.5f;
            int x0 = (int)std::floor(fx);
            float wx = fx - x0;
            int x1 = x0 + 1;
            if (x0 < 0) x0 = 0;
            if (x1 < 0) x1 = 0;
            if (x0 > w - 1) x0 = w - 1;
            if (x1 > w - 1) x1 = w - 1;
            const uint8_t* p00 = src + (y0 * (int64_t)w + x0) * 3;
            const uint8_t* p01 = src + (y0 * (int64_t)w + x1) * 3;
            const uint8_t* p10 = src + (y1 * (int64_t)w + x0) * 3;
            const uint8_t* p11 = src + (y1 * (int64_t)w + x1) * 3;
            uint8_t* o = dst + (oy * (int64_t)out_w + ox) * 3;
            for (int c = 0; c < 3; ++c) {
                float v = (1 - wy) * ((1 - wx) * p00[c] + wx * p01[c]) +
                          wy * ((1 - wx) * p10[c] + wx * p11[c]);
                o[c] = (uint8_t)(v + 0.5f);
            }
        }
    }
}

#if TPU_DIST_HAVE_JPEG
struct ErrMgr {
    jpeg_error_mgr pub;
    std::jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
    std::longjmp(((ErrMgr*)cinfo->err)->jump, 1);
}
#endif

}  // namespace

extern "C" {

int decode_available(void) { return TPU_DIST_HAVE_JPEG; }

// Decode JPEG bytes -> resize short side to pre_short (bilinear, target
// dims from the original geometry) -> center crop (size, size, 3) RGB u8
// into out. Returns 0 on success, nonzero on any decode error (caller
// falls back to PIL).
int decode_jpeg_resize_crop(const uint8_t* data, int64_t len, int size,
                            int pre_short, uint8_t* out) {
#if !TPU_DIST_HAVE_JPEG
    (void)data; (void)len; (void)size; (void)pre_short; (void)out;
    return -1;
#else
    // buffers DECLARED BEFORE setjmp: a longjmp from mid-decode lands back
    // here with both vectors still live, so their destructors run on the
    // error return — no leak, no longjmp-over-unwound-objects UB
    std::vector<uint8_t> pixels, resized;
    jpeg_decompress_struct cinfo;
    ErrMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = on_error;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, (unsigned long)len);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return 2;
    }
    const int w0 = (int)cinfo.image_width, h0 = (int)cinfo.image_height;
    if (w0 <= 0 || h0 <= 0) {
        jpeg_destroy_decompress(&cinfo);
        return 3;
    }
    // target dims from the ORIGINAL geometry (matches the PIL path)
    const double scale = (double)pre_short / (w0 < h0 ? w0 : h0);
    int tw = (int)std::lround(w0 * scale);
    int th = (int)std::lround(h0 * scale);
    if (tw < 1) tw = 1;
    if (th < 1) th = 1;
    // DCT scaling: smallest 1/d (d in 8,4,2,1) still >= the resize target
    cinfo.scale_num = 1;
    cinfo.scale_denom = 1;
    for (int d = 8; d > 1; d /= 2) {
        if (w0 / d >= tw && h0 / d >= th) {
            cinfo.scale_denom = (unsigned)d;
            break;
        }
    }
    cinfo.out_color_space = JCS_RGB;
    // speed knobs: the fast integer DCT and plain (non-fancy) chroma
    // upsampling cost ~1 gray level worst-case vs the accurate paths —
    // noise well below the bilinear resample that follows
    cinfo.dct_method = JDCT_IFAST;
    cinfo.do_fancy_upsampling = FALSE;
    jpeg_start_decompress(&cinfo);
    const int dw = (int)cinfo.output_width, dh = (int)cinfo.output_height;
    pixels.resize((size_t)dw * dh * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = pixels.data() + (size_t)cinfo.output_scanline * dw * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);

    resized.resize((size_t)tw * th * 3);
    resize_bilinear(pixels.data(), dh, dw, resized.data(), th, tw);
    if (th < size || tw < size) return 4;  // pre_short >= size always holds
    const int top = (th - size) / 2, left = (tw - size) / 2;
    for (int y = 0; y < size; ++y) {
        std::memcpy(out + (size_t)y * size * 3,
                    resized.data() + ((size_t)(top + y) * tw + left) * 3,
                    (size_t)size * 3);
    }
    return 0;
#endif
}

}  // extern "C"
