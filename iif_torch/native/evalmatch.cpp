// Greedy COCO/LVIS detection-to-gt matching, C++ core.
//
// The port's copy of iif_tpu/native/evalmatch.cpp, bound with ctypes in
// eval_native.py. Exact transliteration of the per-threshold greedy loop
// in iif_torch/detection/evaluation.py::_greedy_match_py (itself matching
// pycocotools COCOeval.evaluateImg / lvis-api semantics — reference
// call sites mmdet/datasets/lvis.py:309-470, coco.py:362):
//   * detections in descending-score order claim the best-IoU gt
//   * a taken gt may only be re-matched if it is a crowd gt
//   * once a real (non-ignored) gt is the current best, ignored gts
//     cannot displace it (gts arrive sorted real-first, so `break`)
//   * strict improvement only: an equal IoU does not switch gts
// Output is the matched gt index per (threshold, detection), -1 for
// unmatched; the caller derives matched/ignored flags in numpy.
#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

void greedy_match(const double* ious, int64_t n_dt, int64_t n_gt,
                  const uint8_t* g_ignore, const uint8_t* iscrowd,
                  const double* thrs, int64_t n_thr,
                  int64_t* best_out /* n_thr * n_dt */) {
    std::vector<uint8_t> taken(static_cast<size_t>(n_gt));
    const double cap = 1.0 - 1e-10;
    for (int64_t t = 0; t < n_thr; ++t) {
        std::fill(taken.begin(), taken.end(), 0);
        const double thr0 = thrs[t] < cap ? thrs[t] : cap;
        for (int64_t d = 0; d < n_dt; ++d) {
            double best = thr0;
            int64_t bg = -1;
            const double* row = ious + d * n_gt;
            for (int64_t g = 0; g < n_gt; ++g) {
                if (taken[g] && !iscrowd[g]) continue;
                if (bg > -1 && !g_ignore[bg] && g_ignore[g]) break;
                if (row[g] < best) continue;
                best = row[g];
                bg = g;
            }
            best_out[t * n_dt + d] = bg;
            if (bg >= 0) taken[static_cast<size_t>(bg)] = 1;
        }
    }
}

// Batched variant: P (image, category) pairs of one category evaluated
// in a single call — per-pair Python/ctypes dispatch costs more than the
// matching itself at COCO/LVIS scale (tiny D x G matrices), so the pair
// loop lives here. Gts arrive in ORIGINAL annotation order with their
// area-applied ignore flags; the real-first stable reordering the greedy
// rules require is done per pair in C++.
//
// Outputs are written as T x N row-major (N = sum of per-pair dt
// counts), detection columns in pair order — exactly the concatenation
// the accumulate step consumes.
void greedy_match_batch(
    const double* ious_flat, const int64_t* iou_off,
    const int64_t* d_cnt, const int64_t* g_cnt, const int64_t* d_off,
    const int64_t* g_off, int64_t n_pairs, int64_t n_dt_total,
    const uint8_t* g_ignore_flat, const uint8_t* iscrowd_flat,
    const uint8_t* dt_unmatched_ignore_flat,
    const double* thrs, int64_t n_thr,
    uint8_t* matched_out /* n_thr * n_dt_total */,
    uint8_t* ignored_out /* n_thr * n_dt_total */) {
    const double cap = 1.0 - 1e-10;
    std::vector<int64_t> order;
    std::vector<uint8_t> taken;
    for (int64_t p = 0; p < n_pairs; ++p) {
        const int64_t D = d_cnt[p], G = g_cnt[p];
        const double* ious = ious_flat + iou_off[p];
        const uint8_t* gig = g_ignore_flat + g_off[p];
        const uint8_t* crowd = iscrowd_flat + g_off[p];
        const uint8_t* uig = dt_unmatched_ignore_flat + d_off[p];
        // stable real-first order (argsort of the bool ignore flag)
        order.clear();
        for (int64_t g = 0; g < G; ++g) if (!gig[g]) order.push_back(g);
        for (int64_t g = 0; g < G; ++g) if (gig[g]) order.push_back(g);
        taken.assign(static_cast<std::size_t>(G), 0);
        for (int64_t t = 0; t < n_thr; ++t) {
            std::fill(taken.begin(), taken.end(), 0);
            const double thr0 = thrs[t] < cap ? thrs[t] : cap;
            uint8_t* m_row = matched_out + t * n_dt_total + d_off[p];
            uint8_t* i_row = ignored_out + t * n_dt_total + d_off[p];
            for (int64_t d = 0; d < D; ++d) {
                double best = thr0;
                int64_t bg = -1;  // index into `order`
                const double* row = ious + d * G;
                for (int64_t oi = 0; oi < G; ++oi) {
                    const int64_t g = order[static_cast<std::size_t>(oi)];
                    if (taken[static_cast<std::size_t>(g)] && !crowd[g])
                        continue;
                    if (bg > -1 && !gig[order[static_cast<std::size_t>(bg)]]
                        && gig[g])
                        break;
                    if (row[g] < best) continue;
                    best = row[g];
                    bg = oi;
                }
                if (bg < 0) {
                    m_row[d] = 0;
                    i_row[d] = uig[d];
                } else {
                    const int64_t g = order[static_cast<std::size_t>(bg)];
                    m_row[d] = !gig[g];
                    i_row[d] = gig[g];
                    taken[static_cast<std::size_t>(g)] = 1;
                }
            }
        }
    }
}

}  // extern "C"
