// Native RLE mask codec + mask IoU for COCO/LVIS evaluation: the port's
// copy of iif_tpu/native/rle.cpp, bound with ctypes in rle_native.py.
//
// LVIS eval touches up to 300 detection masks an image, far too hot for
// Python loops; the run-intersection IoU never decodes a mask.
//
// Formats match iif_torch/detection/mask_utils.py exactly:
// - counts: column-major run lengths starting with a run of zeros;
// - compressed string: COCO's 6-bit varint delta coding (char '0'+ ...).
//
// Build: g++ -O3 -shared -fPIC (iif_torch/native/build.py).
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Decode compressed counts string -> int64 counts buffer.
// Returns the number of counts written (<= max_counts), or -1 on overflow.
int64_t rle_decompress_counts(const char* s, int64_t slen,
                              int64_t* counts, int64_t max_counts) {
    int64_t n = 0;
    int64_t i = 0;
    while (i < slen) {
        int64_t x = 0;
        int k = 0;
        bool more = true;
        while (more) {
            if (i >= slen) return -1;
            int64_t c = (int64_t)(s[i]) - 48;
            x |= (c & 0x1F) << (5 * k);
            more = (c & 0x20) != 0;
            i++;
            k++;
            if (!more && (c & 0x10)) x |= -1LL << (5 * k);
        }
        if (n > 2) x += counts[n - 2];
        if (n >= max_counts) return -1;
        counts[n++] = x;
    }
    return n;
}

// Compress counts -> string buffer. Returns bytes written or -1 on overflow.
int64_t rle_compress_counts(const int64_t* counts, int64_t n,
                            char* out, int64_t max_out) {
    int64_t m = 0;
    for (int64_t idx = 0; idx < n; idx++) {
        int64_t x = counts[idx];
        if (idx > 2) x -= counts[idx - 2];
        bool more = true;
        while (more) {
            int64_t c = x & 0x1F;
            x >>= 5;
            more = !((x == 0 && !(c & 0x10)) || (x == -1 && (c & 0x10)));
            if (more) c |= 0x20;
            if (m >= max_out) return -1;
            out[m++] = (char)(c + 48);
        }
    }
    return m;
}

// The first nonzero byte of m[i, n), or n: eight bytes a step.
static int64_t next_nonzero(const uint8_t* m, int64_t i, int64_t n) {
    for (; i < n && (i & 7); i++)
        if (m[i]) return i;
    for (; i + 8 <= n; i += 8) {
        uint64_t word;
        std::memcpy(&word, m + i, 8);
        if (word) break;
    }
    for (; i < n; i++)
        if (m[i]) return i;
    return n;
}

// The first zero byte of m[i, n), or n.
static int64_t next_zero(const uint8_t* m, int64_t i, int64_t n) {
    const void* p = std::memchr(m + i, 0, (size_t)(n - i));
    return p ? (const uint8_t*)p - m : n;
}

// Encode a binary HxW mask stored column-major (mask[x * h + y], the
// transpose of a row-major WxH array) into counts, read in memory order,
// each run found by a scan for its end. Returns the number of counts.
// (The JAX package's rle_encode_mask reads a row-major mask across its
// strides; the port's one caller reads masks back column-major.)
int64_t rle_encode_mask_colmajor(const uint8_t* mask, int64_t h, int64_t w,
                                 int64_t* counts, int64_t max_counts) {
    const int64_t total = h * w;
    if (total == 0) {  // one empty run of zeros
        if (max_counts < 1) return -1;
        counts[0] = 0;
        return 1;
    }
    int64_t n = 0;
    bool ones = false;  // runs start with zeros
    for (int64_t i = 0; i < total;) {
        const int64_t j = ones ? next_zero(mask, i, total)
                               : next_nonzero(mask, i, total);
        if (n >= max_counts) return -1;
        counts[n++] = j - i;
        i = j;
        ones = !ones;
    }
    return n;
}

// Decode counts into a row-major HxW uint8 mask.
void rle_decode_mask(const int64_t* counts, int64_t n, int64_t h, int64_t w,
                     uint8_t* mask) {
    std::memset(mask, 0, (size_t)(h * w));
    int64_t pos = 0;
    uint8_t val = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t c = counts[i];
        if (val) {
            for (int64_t j = pos; j < pos + c && j < h * w; j++) {
                int64_t x = j / h;   // column-major position
                int64_t y = j % h;
                mask[y * w + x] = 1;
            }
        }
        pos += c;
        val ^= 1;
    }
}

// Area of an RLE (sum of the 1-runs).
int64_t rle_area(const int64_t* counts, int64_t n) {
    int64_t a = 0;
    for (int64_t i = 1; i < n; i += 2) a += counts[i];
    return a;
}

// Intersection of two RLEs (column-major run intersection, no decode).
int64_t rle_intersection(const int64_t* ca, int64_t na,
                         const int64_t* cb, int64_t nb) {
    int64_t inter = 0;
    int64_t ia = 0, ib = 0;
    int64_t enda = ca[0], endb = cb[0];  // end position of current run
    int64_t pos = 0;
    uint8_t va = 0, vb = 0;
    while (ia < na && ib < nb) {
        int64_t next_end = enda < endb ? enda : endb;
        if (va && vb) inter += next_end - pos;
        pos = next_end;
        if (enda == next_end) {
            ia++;
            va ^= 1;
            if (ia < na) enda += ca[ia];
        }
        if (endb == next_end && ib < nb) {
            ib++;
            vb ^= 1;
            if (ib < nb) endb += cb[ib];
        }
    }
    return inter;
}

// Pairwise IoU of D detection RLEs vs G gt RLEs (flattened counts + offsets).
// iscrowd: per-gt flag -> IoF denominator.
void rle_iou_matrix(
    const int64_t* d_counts, const int64_t* d_offsets, const int64_t* d_lens,
    int64_t n_d,
    const int64_t* g_counts, const int64_t* g_offsets, const int64_t* g_lens,
    int64_t n_g,
    const uint8_t* iscrowd,
    double* out /* n_d * n_g */) {
    std::vector<int64_t> d_area(n_d), g_area(n_g);
    for (int64_t i = 0; i < n_d; i++)
        d_area[i] = rle_area(d_counts + d_offsets[i], d_lens[i]);
    for (int64_t j = 0; j < n_g; j++)
        g_area[j] = rle_area(g_counts + g_offsets[j], g_lens[j]);
    for (int64_t i = 0; i < n_d; i++) {
        for (int64_t j = 0; j < n_g; j++) {
            int64_t inter = rle_intersection(
                d_counts + d_offsets[i], d_lens[i],
                g_counts + g_offsets[j], g_lens[j]);
            double uni = iscrowd[j]
                ? (double)d_area[i]
                : (double)(d_area[i] + g_area[j] - inter);
            out[i * n_g + j] = uni > 0 ? (double)inter / uni : 0.0;
        }
    }
}

}  // extern "C"
