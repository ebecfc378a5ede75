// Greedy COCO detection<->ground-truth matching core.
//
// The reference scored results with pycocotools inside Docker
// (`Sources/maskrcnn/Python/COCOEval/task.py:97-98`); this framework scores
// in-process, and the per-(category, image) matching — score-ordered greedy
// assignment per IoU threshold and area range, with crowd multi-matching and
// the ignored-gt cutoff rule — is the scoring hot loop at val2017 scale
// (80 cats x 5k images x 4 areas x 10 thresholds). One call handles every
// (area, threshold) pair for one (category, image), so the Python layer pays
// one FFI crossing per pair instead of A*T*D interpreter iterations.
//
// Matching semantics (the published COCO evaluation protocol):
//   * detections are pre-sorted by descending score, capped at max(maxDets);
//   * ground truths are scanned non-ignored first (stable), then ignored;
//   * a detection takes the best-IoU ground truth with IoU >= threshold,
//     later-scanned equal-IoU candidates winning ties;
//   * an already-matched gt is unavailable unless it is a crowd;
//   * once a non-ignored match is in hand, scanning stops at the first
//     ignored gt (an ignored match never displaces a non-ignored one);
//   * a detection matched to an ignored gt, or unmatched with area outside
//     the range, is flagged ignored (neither TP nor FP).

#include <cstdint>

extern "C" {

// ious:      D*G row-major IoU matrix (crowd columns already computed as
//            intersection/dt_area by the RLE/bbox IoU kernels).
// g_ign:     A*G  per-area gt ignore flags (ignore|iscrowd|area-out).
// g_crowd:   G    gt iscrowd flags.
// d_out:     A*D  per-area dt out-of-range flags.
// thrs:      T    IoU thresholds.
// dtm:       A*T*D out — matched gt index, -1 = unmatched.
// d_ignore:  A*T*D out — detection ignored flags.
// n_gt:      A    out — count of non-ignored gts per area range.
void eval_match(const double* ious, int64_t D, int64_t G,
                const uint8_t* g_ign, const uint8_t* g_crowd,
                const uint8_t* d_out, int64_t A,
                const double* thrs, int64_t T,
                int64_t* dtm, uint8_t* d_ignore, int64_t* n_gt) {
  // Scan order: non-ignored gts first (stable), ignored after — per area.
  // Built once per (area) into a scratch index list on the stack-ish heap.
  int64_t* order = new int64_t[G];
  int64_t* gtm = new int64_t[G];

  for (int64_t a = 0; a < A; ++a) {
    const uint8_t* gi = g_ign + a * G;
    const uint8_t* dout = d_out + a * D;
    int64_t n = 0;
    int64_t pos = 0;
    for (int64_t g = 0; g < G; ++g)
      if (!gi[g]) { order[pos++] = g; ++n; }
    for (int64_t g = 0; g < G; ++g)
      if (gi[g]) order[pos++] = g;
    n_gt[a] = n;

    for (int64_t t = 0; t < T; ++t) {
      const double thr_raw = thrs[t];
      const double thr = thr_raw < 1.0 - 1e-10 ? thr_raw : 1.0 - 1e-10;
      int64_t* dm = dtm + (a * T + t) * D;
      uint8_t* dig = d_ignore + (a * T + t) * D;
      for (int64_t g = 0; g < G; ++g) gtm[g] = -1;

      for (int64_t d = 0; d < D; ++d) {
        double best = thr;
        int64_t m = -1;
        const double* iou_row = ious + d * G;
        for (int64_t p = 0; p < G; ++p) {
          const int64_t g = order[p];
          if (gtm[g] >= 0 && !g_crowd[g]) continue;
          if (m >= 0 && !gi[m] && gi[g]) break;
          if (iou_row[g] < best) continue;
          best = iou_row[g];
          m = g;
        }
        dm[d] = m;
        if (m >= 0) {
          gtm[m] = d;
          dig[d] = gi[m];
        } else {
          dig[d] = dout[d];
        }
      }
    }
  }
  delete[] order;
  delete[] gtm;
}

}  // extern "C"
