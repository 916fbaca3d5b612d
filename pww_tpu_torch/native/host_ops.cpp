// Native host-side ops for the conditioning prologue.
//
// The reference does this work with per-color numpy broadcasting and PIL
// (reference paint_with_words/paint_with_words.py:231-236, gradio_pww.py:69-85);
// at interactive serving sizes (1024² maps × 8 colors per request) the
// single-pass C++ versions keep the host prologue off the request critical
// path. Exposed via ctypes (see native/__init__.py), which builds this file
// at first use; native/plain.py holds the numpy versions the tests hold it
// against.
//
// Build: g++ -O3 -shared -fPIC host_ops.cpp -o libpww_host.so
#include <cstdint>
#include <cstring>

extern "C" {

// Exact color-match masks, one image pass for all colors.
// img: (h*w*3) uint8, colors: (n*3) uint8, strengths: (n) float,
// out: (n*h*w) float32 (mask scaled by strength), counts: (n) int64.
void color_masks(const uint8_t* img, int64_t h, int64_t w,
                 const uint8_t* colors, const float* strengths, int64_t n,
                 float* out, int64_t* counts) {
    const int64_t hw = h * w;
    std::memset(out, 0, sizeof(float) * n * hw);
    std::memset(counts, 0, sizeof(int64_t) * n);
    for (int64_t p = 0; p < hw; ++p) {
        const uint8_t r = img[3 * p], g = img[3 * p + 1], b = img[3 * p + 2];
        for (int64_t c = 0; c < n; ++c) {
            if (r == colors[3 * c] && g == colors[3 * c + 1] &&
                b == colors[3 * c + 2]) {
                out[c * hw + p] = strengths[c];
                ++counts[c];
            }
        }
    }
}

// Squared-distance color mask (web-UI extraction tool, threshold 30).
void color_mask_sqdist(const uint8_t* img, int64_t h, int64_t w,
                       const uint8_t* color, int64_t threshold,
                       uint8_t* out) {
    const int64_t hw = h * w;
    const int64_t cr = color[0], cg = color[1], cb = color[2];
    for (int64_t p = 0; p < hw; ++p) {
        const int64_t dr = (int64_t)img[3 * p] - cr;
        const int64_t dg = (int64_t)img[3 * p + 1] - cg;
        const int64_t db = (int64_t)img[3 * p + 2] - cb;
        out[p] = (dr * dr + dg * dg + db * db) < threshold ? 1 : 0;
    }
}

// Dominant-color histogram over packed 24-bit RGB. Returns number of
// distinct colors written (capped at max_out), ordered by count desc.
// Uses a 2^24-entry count table (64 MiB transient) — one pass, no sort of
// the full image.
int64_t unique_colors(const uint8_t* img, int64_t h, int64_t w,
                      int64_t min_count, uint8_t* out_colors,
                      int64_t* out_counts, int64_t max_out) {
    const int64_t hw = h * w;
    static thread_local int32_t* table = nullptr;
    if (!table) table = new int32_t[1 << 24]();
    // collect touched keys to reset cheaply afterwards
    int64_t n_touched = 0;
    int32_t* touched = new int32_t[hw];
    for (int64_t p = 0; p < hw; ++p) {
        const int32_t key = (img[3 * p] << 16) | (img[3 * p + 1] << 8) |
                            img[3 * p + 2];
        if (table[key]++ == 0) touched[n_touched++] = key;
    }
    // selection of top-max_out by count
    int64_t n_out = 0;
    for (int64_t slot = 0; slot < max_out; ++slot) {
        int32_t best_key = -1;
        int32_t best_count = 0;
        for (int64_t i = 0; i < n_touched; ++i) {
            const int32_t k = touched[i];
            if (table[k] > best_count) {
                best_count = table[k];
                best_key = k;
            }
        }
        if (best_key < 0 || best_count < min_count) break;
        out_colors[3 * n_out] = (best_key >> 16) & 0xFF;
        out_colors[3 * n_out + 1] = (best_key >> 8) & 0xFF;
        out_colors[3 * n_out + 2] = best_key & 0xFF;
        out_counts[n_out] = best_count;
        table[best_key] = 0;
        ++n_out;
    }
    for (int64_t i = 0; i < n_touched; ++i) table[touched[i]] = 0;
    delete[] touched;
    return n_out;
}

// All substring occurrences of `sub` (m ints) in `ids` (n ints); writes the
// per-position occurrence-count row used by the token-match matrix
// (reference paint_with_words.py:259-268 semantics, incl. overlaps).
int64_t token_match_row(const int64_t* ids, int64_t n, const int64_t* sub,
                        int64_t m, float* row) {
    std::memset(row, 0, sizeof(float) * n);
    int64_t hits = 0;
    for (int64_t i = 0; i + m <= n; ++i) {
        bool ok = true;
        for (int64_t j = 0; j < m; ++j) {
            if (ids[i + j] != sub[j]) { ok = false; break; }
        }
        if (ok) {
            ++hits;
            for (int64_t j = 0; j < m; ++j) row[i + j] += 1.0f;
        }
    }
    return hits;
}

}  // extern "C"
