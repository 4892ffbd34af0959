// COCOeval bbox helpers for the host side of evaluation: the pairwise IoU
// of xywh boxes and the greedy threshold matching, the two loops of
// pycocotools' per-(image, category) evaluateImg that dominate its time.
//
// The arithmetic is evaluate/coco_eval.py's numpy oracle
// (numpy_bbox_iou_xywh, numpy_match_detections), operation for operation,
// so the results are bit-identical (tests/test_torch_cocoeval_native.py).
// Plain C interface, bound with ctypes (evaluate/_native.py), so a call runs
// without the interpreter lock; built by native/build.py.

#include <cstdint>

extern "C" {

// Pairwise IoU of xywh boxes, crowd-aware (crowd gt: denominator = det area).
// dt: D*4, gt: G*4, iscrowd: G, out: D*G (det-major).
void iou_matrix_xywh(const double* dt, int64_t D, const double* gt, int64_t G,
                     const uint8_t* iscrowd, double* out) {
  for (int64_t d = 0; d < D; ++d) {
    const double dx1 = dt[d * 4 + 0], dy1 = dt[d * 4 + 1];
    const double dw = dt[d * 4 + 2], dh = dt[d * 4 + 3];
    const double dx2 = dx1 + dw, dy2 = dy1 + dh;
    const double d_area = dw * dh;
    for (int64_t g = 0; g < G; ++g) {
      const double gx1 = gt[g * 4 + 0], gy1 = gt[g * 4 + 1];
      const double gw = gt[g * 4 + 2], gh = gt[g * 4 + 3];
      const double gx2 = gx1 + gw, gy2 = gy1 + gh;
      const double iw_hi = (dx2 < gx2 ? dx2 : gx2) - (dx1 > gx1 ? dx1 : gx1);
      const double ih_hi = (dy2 < gy2 ? dy2 : gy2) - (dy1 > gy1 ? dy1 : gy1);
      const double iw = iw_hi > 0.0 ? iw_hi : 0.0;
      const double ih = ih_hi > 0.0 ? ih_hi : 0.0;
      const double inter = iw * ih;
      const double uni =
          iscrowd[g] ? d_area : d_area + gw * gh - inter;
      out[d * G + g] = uni > 0.0
                           ? inter / (uni > 1e-12 ? uni : 1e-12)
                           : 0.0;
    }
  }
}

// Greedy COCOeval matching for all T thresholds at once.
//
// Inputs are in the SAME layout the numpy oracle uses after its sorts:
// dets score-sorted (descending), gts ignore-sorted (non-ignored first).
// ious: D*G det-major. iou_thrs: T. g_ignore/g_crowd: G.
// Outputs (caller-allocated): dtm/gtm int64 T*D / T*G filled with the
// matched counterpart index or -1; dt_ignore uint8 T*D.
void match_detections(const double* ious, int64_t D, int64_t G,
                      const double* iou_thrs, int64_t T,
                      const uint8_t* g_ignore, const uint8_t* g_crowd,
                      int64_t* dtm, int64_t* gtm, uint8_t* dt_ignore) {
  for (int64_t i = 0; i < T * D; ++i) dtm[i] = -1;
  for (int64_t i = 0; i < T * G; ++i) gtm[i] = -1;
  for (int64_t i = 0; i < T * D; ++i) dt_ignore[i] = 0;

  for (int64_t t = 0; t < T; ++t) {
    const double thr = iou_thrs[t];
    for (int64_t d = 0; d < D; ++d) {
      // Match at IoU >= thr; 1-1e-10 cap mirrors pycocotools.
      double best = thr < 1.0 - 1e-10 ? thr : 1.0 - 1e-10;
      int64_t m = -1;
      const double* row = ious + d * G;
      for (int64_t g = 0; g < G; ++g) {
        if (gtm[t * G + g] >= 0 && !g_crowd[g]) continue;
        if (m > -1 && !g_ignore[m] && g_ignore[g]) break;
        if (row[g] < best) continue;
        best = row[g];
        m = g;
      }
      if (m == -1) continue;
      dtm[t * D + d] = m;
      gtm[t * G + m] = d;
      dt_ignore[t * D + d] = g_ignore[m];
    }
  }
}

}  // extern "C"
