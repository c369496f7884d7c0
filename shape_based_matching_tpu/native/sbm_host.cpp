// Native host-side kernels for the order-dependent greedy algorithms.
//
// The device handles the dense work; these cover the reference's inherently
// sequential host loops, which become the training-side bottleneck when
// building large (1000+) template banks:
//   * greedy 5x5 magnitude-NMS acceptance scan (line2Dup.cpp:466-511
//     semantics, reduced to its order-equivalent acceptance rule),
//   * scattered feature selection (line2Dup.cpp:163-212),
//   * detection-level greedy IoU NMS (nms.hpp:40-66).
// Exposed with a C ABI for ctypes; the Python fallbacks in
// models/training.py and utils/nms.py implement identical semantics.
//
// Build: python -m shape_based_matching_tpu.native.build

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Row-major greedy acceptance: for each candidate (ys[i], xs[i]) in order,
// accept iff no previously accepted point lies within Chebyshev distance 2.
// Writes 0/1 flags to out. Candidates must be in row-major scan order.
void sbm_greedy_accept(int h, int w, int n, const int32_t* ys,
                       const int32_t* xs, uint8_t* out) {
    std::vector<uint8_t> occupied((size_t)h * w, 0);
    for (int i = 0; i < n; ++i) {
        int r = ys[i], c = xs[i];
        int r0 = r - 2 < 0 ? 0 : r - 2;
        int r1 = r + 3 > h ? h : r + 3;
        int c0 = c - 2 < 0 ? 0 : c - 2;
        int c1 = c + 3 > w ? w : c + 3;
        uint8_t hit = 0;
        for (int rr = r0; rr < r1 && !hit; ++rr) {
            const uint8_t* row = occupied.data() + (size_t)rr * w;
            for (int cc = c0; cc < c1; ++cc) {
                if (row[cc]) { hit = 1; break; }
            }
        }
        out[i] = !hit;
        if (!hit) occupied[(size_t)r * w + c] = 1;
    }
}

// selectScatteredFeatures (line2Dup.cpp:163-212): candidates are
// score-sorted; returns the number of selected indices written to out_idx
// (capacity must be >= n).
int sbm_select_scattered(int n, const int32_t* xs, const int32_t* ys,
                         int num_features, float distance,
                         int32_t* out_idx) {
    std::vector<int32_t> features;
    features.reserve((size_t)num_features * 2);
    float distance_sq = distance * distance;
    int i = 0;
    bool first_select = true;
    while (true) {
        int cx = xs[i], cy = ys[i];
        bool keep = true;
        for (size_t j = 0; j < features.size(); ++j) {
            int f = features[j];
            float dx = (float)(cx - xs[f]);
            float dy = (float)(cy - ys[f]);
            if (dx * dx + dy * dy < distance_sq) { keep = false; break; }
        }
        if (keep) features.push_back(i);
        if (++i == n) {
            bool num_ok = (int)features.size() >= num_features;
            if (first_select) {
                if (num_ok) {
                    features.clear();
                    i = 0;
                    distance += 1.0f;
                    distance_sq = distance * distance;
                    continue;
                }
                first_select = false;
            }
            i = 0;
            distance -= 1.0f;
            distance_sq = distance * distance;
            if (num_ok || distance < 3) break;
        }
    }
    int cnt = (int)features.size();
    std::memcpy(out_idx, features.data(), sizeof(int32_t) * cnt);
    return cnt;
}

// Greedy IoU NMS (nms.hpp semantics). boxes: [n][4] (x, y, w, h) float;
// order: pre-sorted candidate indices (score desc, stable); returns count
// of kept indices written to out_idx.
int sbm_nms_boxes(int n, const float* boxes, const int32_t* order,
                  int n_order, float nms_threshold, float eta,
                  int32_t* out_idx) {
    std::vector<int32_t> keep;
    float adaptive = nms_threshold;
    for (int oi = 0; oi < n_order; ++oi) {
        int i = order[oi];
        const float* a = boxes + (size_t)i * 4;
        bool ok = true;
        for (size_t kj = 0; kj < keep.size(); ++kj) {
            const float* b = boxes + (size_t)keep[kj] * 4;
            float area_a = a[2] * a[3];
            float area_b = b[2] * b[3];
            float overlap;
            if (area_a + area_b <= 1.192092896e-07f) {
                overlap = 1.0f;
            } else {
                float ix0 = a[0] > b[0] ? a[0] : b[0];
                float iy0 = a[1] > b[1] ? a[1] : b[1];
                float ix1 = (a[0] + a[2]) < (b[0] + b[2]) ? a[0] + a[2]
                                                          : b[0] + b[2];
                float iy1 = (a[1] + a[3]) < (b[1] + b[3]) ? a[1] + a[3]
                                                          : b[1] + b[3];
                float iw = ix1 - ix0 > 0 ? ix1 - ix0 : 0;
                float ih = iy1 - iy0 > 0 ? iy1 - iy0 : 0;
                float inter = iw * ih;
                overlap = (float)(inter / (area_a + area_b - inter));
            }
            if (overlap > adaptive) { ok = false; break; }
        }
        if (ok) {
            keep.push_back(i);
            if (eta < 1 && adaptive > 0.5f) adaptive *= eta;
        }
    }
    std::memcpy(out_idx, keep.data(), sizeof(int32_t) * keep.size());
    return (int)keep.size();
}

}  // extern "C"
