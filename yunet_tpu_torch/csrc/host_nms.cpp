// Native host kernels for yunet_tpu.
//
// The reference delegates its hot host-side ops to mmcv's C++ extensions
// (NMS) and to a multiprocessing pool for WIDER AP matching
// (core/evaluation/widerface.py:284-287). Here the same roles are filled by
// a small C++ library loaded via ctypes:
//   - exact uncapped greedy NMS (mmcv::ops::nms semantics: scores already
//     thresholded by the caller, suppress IoU > thr)
//   - the per-image WIDER evaluation matching loop (greedy IoU-0.5 with
//     ignore handling and the legacy +1 pixel IoU convention)
//
// Build: g++ -O3 -march=native -shared -fPIC yunet_ops.cpp -o libyunet_ops.so

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// Greedy NMS. boxes: n*4 xyxy, scores: n. keep_out: caller-allocated n ints.
// Returns number of kept boxes; keep_out[0..ret) are kept indices in
// score-descending order.
int nms_f32(const float* boxes, const float* scores, int n, float iou_thr,
            int* keep_out) {
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return scores[a] > scores[b]; });
  std::vector<float> area(n);
  for (int i = 0; i < n; ++i) {
    const float* b = boxes + 4 * i;
    area[i] = std::max(0.f, b[2] - b[0]) * std::max(0.f, b[3] - b[1]);
  }
  std::vector<char> suppressed(n, 0);
  int num_kept = 0;
  for (int oi = 0; oi < n; ++oi) {
    int i = order[oi];
    if (suppressed[i]) continue;
    keep_out[num_kept++] = i;
    const float* bi = boxes + 4 * i;
    for (int oj = oi + 1; oj < n; ++oj) {
      int j = order[oj];
      if (suppressed[j]) continue;
      const float* bj = boxes + 4 * j;
      float ix1 = std::max(bi[0], bj[0]);
      float iy1 = std::max(bi[1], bj[1]);
      float ix2 = std::min(bi[2], bj[2]);
      float iy2 = std::min(bi[3], bj[3]);
      float w = std::max(0.f, ix2 - ix1);
      float h = std::max(0.f, iy2 - iy1);
      float inter = w * h;
      float uni = area[i] + area[j] - inter;
      if (uni > 0.f && inter / uni > iou_thr) suppressed[j] = 1;
    }
  }
  return num_kept;
}

// WIDER single-image greedy matching (semantics of the official eval):
// preds: np*5 (x1,y1,w,h,score) already score-desc; gts: ng*4 (x1,y1,w,h);
// keep: ng ints (1 = evaluated face, 0 = ignored face).
// Outputs:
//   pred_recall: np ints — cumulative count of claimed (evaluated) gts
//                after considering pred h
//   proposal:    np ints — 1 if pred counts as a proposal, -1 if it matched
//                an ignored face (excluded from precision)
// Uses the legacy +1 IoU convention of the official widerface tool.
void wider_match(const float* preds, int np, const float* gts, int ng,
                 const int* keep, float iou_thr, int* pred_recall,
                 int* proposal) {
  std::vector<signed char> recall_list(ng, 0);
  int claimed = 0;
  for (int h = 0; h < np; ++h) {
    proposal[h] = 1;
    const float* p = preds + 5 * h;
    float px1 = p[0], py1 = p[1], px2 = p[0] + p[2], py2 = p[1] + p[3];
    float parea = (px2 - px1 + 1.f) * (py2 - py1 + 1.f);
    float best = -1.f;
    int best_k = -1;
    for (int k = 0; k < ng; ++k) {
      const float* g = gts + 4 * k;
      float gx1 = g[0], gy1 = g[1], gx2 = g[0] + g[2], gy2 = g[1] + g[3];
      float w = std::min(px2, gx2) - std::max(px1, gx1) + 1.f;
      float hh = std::min(py2, gy2) - std::max(py1, gy1) + 1.f;
      float ov = 0.f;
      if (w > 0.f && hh > 0.f) {
        float inter = w * hh;
        float garea = (gx2 - gx1 + 1.f) * (gy2 - gy1 + 1.f);
        ov = inter / (parea + garea - inter);
      }
      if (ov > best) {
        best = ov;
        best_k = k;
      }
    }
    if (best_k >= 0 && best >= iou_thr) {
      if (keep[best_k] == 0) {
        recall_list[best_k] = -1;
        proposal[h] = -1;
      } else if (recall_list[best_k] == 0) {
        recall_list[best_k] = 1;
        ++claimed;
      }
    }
    pred_recall[h] = claimed;
  }
}

}  // extern "C"
