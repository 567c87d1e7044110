// Native Y4M (YUV4MPEG2 C420) demuxer — the data-loader role of the
// reference's native frame plumbing (its Rust capture crates fed raw frames
// from native code; here the video ingest path gets the same treatment).
//
// Parses the stream header, reads frames sequentially, and converts
// YUV420 → RGBA in C++ (BT.601 full-swing, nearest chroma upsample —
// bit-identical to nu_scaler_tpu_torch/capture/video._yuv420_to_rgba: float
// math, clip, truncate). Exposed behind a C ABI consumed via ctypes
// (nu_scaler_tpu_torch/capture/video.NativeY4MReader); pure-Python fallback
// when no compiler exists.
//
// Build: g++ at the first use, into build/nu_scaler_tpu_torch/ under a name
// keyed by this source's hash (nu_scaler_tpu_torch/kernels/_build.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Y4M {
    FILE* f = nullptr;
    uint32_t w = 0, h = 0;
    double fps = 30.0;
    long data_start = 0;
    std::vector<uint8_t> buf;  // one frame of YUV420
};

inline uint8_t clamp_u8(double v) {
    if (v < 0.0) v = 0.0;
    if (v > 255.0) v = 255.0;
    return static_cast<uint8_t>(v);  // truncation, matching numpy's cast
}

}  // namespace

extern "C" {

void* nu_y4m_open(const char* path, uint32_t* w, uint32_t* h, double* fps) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    char line[512];
    if (!std::fgets(line, sizeof(line), f)) {
        std::fclose(f);
        return nullptr;
    }
    if (std::strncmp(line, "YUV4MPEG2", 9) != 0) {
        std::fclose(f);
        return nullptr;
    }
    auto* ctx = new Y4M();
    ctx->f = f;
    for (char* tok = std::strtok(line + 9, " \n"); tok; tok = std::strtok(nullptr, " \n")) {
        switch (tok[0]) {
            case 'W': ctx->w = std::strtoul(tok + 1, nullptr, 10); break;
            case 'H': ctx->h = std::strtoul(tok + 1, nullptr, 10); break;
            case 'F': {
                char* colon = std::strchr(tok + 1, ':');
                if (colon) {
                    double num = std::strtod(tok + 1, nullptr);
                    double den = std::strtod(colon + 1, nullptr);
                    if (den > 0) ctx->fps = num / den;
                }
                break;
            }
            case 'C':
                if (std::strncmp(tok + 1, "420", 3) != 0) {  // only C420*
                    std::fclose(f);
                    delete ctx;
                    return nullptr;
                }
                break;
            default: break;
        }
    }
    if (!ctx->w || !ctx->h) {
        std::fclose(f);
        delete ctx;
        return nullptr;
    }
    ctx->data_start = std::ftell(f);
    ctx->buf.resize(ctx->w * ctx->h + 2 * ((ctx->w / 2) * (ctx->h / 2)));
    if (w) *w = ctx->w;
    if (h) *h = ctx->h;
    if (fps) *fps = ctx->fps;
    return ctx;
}

// 1 = frame written to rgba_out (w*h*4 bytes), 0 = EOF, -1 = stream error
int nu_y4m_next(void* vctx, uint8_t* rgba_out) {
    auto* ctx = static_cast<Y4M*>(vctx);
    char marker[256];
    if (!std::fgets(marker, sizeof(marker), ctx->f)) return 0;
    if (std::strncmp(marker, "FRAME", 5) != 0) return -1;
    const size_t need = ctx->buf.size();
    if (std::fread(ctx->buf.data(), 1, need, ctx->f) != need) return 0;

    const uint32_t w = ctx->w, h = ctx->h;
    const uint8_t* Y = ctx->buf.data();
    const uint8_t* U = Y + w * h;
    const uint8_t* V = U + (w / 2) * (h / 2);
    const uint32_t cw = w / 2;

    for (uint32_t r = 0; r < h; ++r) {
        const uint8_t* urow = U + (r / 2) * cw;
        const uint8_t* vrow = V + (r / 2) * cw;
        const uint8_t* yrow = Y + r * w;
        uint8_t* out = rgba_out + static_cast<size_t>(r) * w * 4;
        for (uint32_t c = 0; c < w; ++c) {
            // numpy promotes (f32 array) * (python float) to float64 — match
            const double yf = static_cast<double>(yrow[c]);
            const double uf = static_cast<double>(urow[c / 2]) - 128.0;
            const double vf = static_cast<double>(vrow[c / 2]) - 128.0;
            out[c * 4 + 0] = clamp_u8(yf + 1.402 * vf);
            out[c * 4 + 1] = clamp_u8(yf - 0.344136 * uf - 0.714136 * vf);
            out[c * 4 + 2] = clamp_u8(yf + 1.772 * uf);
            out[c * 4 + 3] = 255;
        }
    }
    return 1;
}

void nu_y4m_rewind(void* vctx) {
    auto* ctx = static_cast<Y4M*>(vctx);
    std::fseek(ctx->f, ctx->data_start, SEEK_SET);
}

void nu_y4m_close(void* vctx) {
    auto* ctx = static_cast<Y4M*>(vctx);
    if (ctx->f) std::fclose(ctx->f);
    delete ctx;
}

}  // extern "C"
