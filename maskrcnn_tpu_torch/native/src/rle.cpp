// Native RLE mask codec + geometry for COCO-style evaluation.
//
// The reference scores COCO AP through pycocotools inside Docker
// (Sources/maskrcnn/Python/COCOEval/task.py:97-98). This framework scores
// in-process; the hot mask math (run-length encode/decode, RLE IoU/area/
// merge, polygon rasterization) lives here as a from-scratch C++ core with a
// plain C ABI, loaded via ctypes. Masks use COCO's convention: column-major
// (Fortran) order, runs alternating background/foreground starting with
// background.
//
// Build: g++ -O3 -march=native -shared -fPIC rle.cpp -o librle.so

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Encode a column-major binary mask (h*w uint8) into run counts.
// Returns number of runs written (<= h*w+1). counts must have h*w+1 slots.
// ---------------------------------------------------------------------------
int64_t rle_encode(const uint8_t* mask, int64_t h, int64_t w,
                   uint32_t* counts) {
  const int64_t n = h * w;
  int64_t nruns = 0;
  uint8_t cur = 0;  // runs start with background count (possibly 0)
  int64_t run = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t v = mask[i] ? 1 : 0;
    if (v != cur) {
      counts[nruns++] = static_cast<uint32_t>(run);
      run = 0;
      cur = v;
    }
    ++run;
  }
  counts[nruns++] = static_cast<uint32_t>(run);
  return nruns;
}

// Same, but reading a ROW-major (h, w) mask in column order via strided
// accesses — saves the caller a Fortran-order copy of the whole canvas.
int64_t rle_encode_rowmajor(const uint8_t* mask, int64_t h, int64_t w,
                            uint32_t* counts) {
  int64_t nruns = 0;
  uint8_t cur = 0;
  int64_t run = 0;
  for (int64_t x = 0; x < w; ++x) {
    const uint8_t* col = mask + x;
    for (int64_t y = 0; y < h; ++y) {
      const uint8_t v = col[y * w] ? 1 : 0;
      if (v != cur) {
        counts[nruns++] = static_cast<uint32_t>(run);
        run = 0;
        cur = v;
      }
      ++run;
    }
  }
  counts[nruns++] = static_cast<uint32_t>(run);
  return nruns;
}

// ---------------------------------------------------------------------------
// Decode run counts back into a column-major uint8 mask.
// ---------------------------------------------------------------------------
void rle_decode(const uint32_t* counts, int64_t nruns, int64_t h, int64_t w,
                uint8_t* mask) {
  int64_t pos = 0;
  const int64_t n = h * w;
  uint8_t v = 0;
  for (int64_t r = 0; r < nruns && pos < n; ++r) {
    int64_t len = counts[r];
    if (len > n - pos) len = n - pos;
    std::memset(mask + pos, v, static_cast<size_t>(len));
    pos += len;
    v = 1 - v;
  }
  if (pos < n) std::memset(mask + pos, 0, static_cast<size_t>(n - pos));
}

// ---------------------------------------------------------------------------
// Area (foreground pixel count) of an RLE.
// ---------------------------------------------------------------------------
uint64_t rle_area(const uint32_t* counts, int64_t nruns) {
  uint64_t area = 0;
  for (int64_t r = 1; r < nruns; r += 2) area += counts[r];
  return area;
}

// ---------------------------------------------------------------------------
// Intersection area of two RLEs over the same h*w grid (merge-walk, no
// decode). Runs alternate bg/fg starting at bg.
// ---------------------------------------------------------------------------
uint64_t rle_intersection(const uint32_t* a, int64_t na, const uint32_t* b,
                          int64_t nb) {
  uint64_t inter = 0;
  int64_t ia = 0, ib = 0;
  uint64_t ca = ia < na ? a[0] : 0, cb = ib < nb ? b[0] : 0;
  uint8_t va = 0, vb = 0;
  while (ia < na && ib < nb) {
    const uint64_t step = std::min(ca, cb);
    if (va && vb) inter += step;
    ca -= step;
    cb -= step;
    if (ca == 0) {
      ++ia;
      va = 1 - va;
      if (ia < na) ca = a[ia];
    }
    if (cb == 0) {
      ++ib;
      vb = 1 - vb;
      if (ib < nb) cb = b[ib];
    }
  }
  return inter;
}

// ---------------------------------------------------------------------------
// Pairwise IoU between detection RLEs and GT RLEs.
// dt/gt: concatenated counts with per-mask offsets. iscrowd GT uses the
// pycocotools convention: iou = intersection / dt_area.
// ---------------------------------------------------------------------------
void rle_iou_matrix(const uint32_t* dt_counts, const int64_t* dt_off,
                    const int64_t* dt_len, int64_t ndt,
                    const uint32_t* gt_counts, const int64_t* gt_off,
                    const int64_t* gt_len, int64_t ngt,
                    const uint8_t* gt_iscrowd, double* iou) {
  std::vector<uint64_t> dt_area(ndt), gt_area(ngt);
  for (int64_t i = 0; i < ndt; ++i)
    dt_area[i] = rle_area(dt_counts + dt_off[i], dt_len[i]);
  for (int64_t j = 0; j < ngt; ++j)
    gt_area[j] = rle_area(gt_counts + gt_off[j], gt_len[j]);
  for (int64_t i = 0; i < ndt; ++i) {
    for (int64_t j = 0; j < ngt; ++j) {
      const uint64_t inter = rle_intersection(
          dt_counts + dt_off[i], dt_len[i], gt_counts + gt_off[j], gt_len[j]);
      double denom;
      if (gt_iscrowd && gt_iscrowd[j])
        denom = static_cast<double>(dt_area[i]);
      else
        denom = static_cast<double>(dt_area[i] + gt_area[j] - inter);
      iou[i * ngt + j] = denom > 0 ? static_cast<double>(inter) / denom : 0.0;
    }
  }
}

// ---------------------------------------------------------------------------
// Box IoU matrix, boxes as (x, y, w, h) like COCO. iscrowd same convention.
// ---------------------------------------------------------------------------
void bbox_iou_matrix(const double* dt, int64_t ndt, const double* gt,
                     int64_t ngt, const uint8_t* gt_iscrowd, double* iou) {
  for (int64_t i = 0; i < ndt; ++i) {
    const double ax = dt[i * 4], ay = dt[i * 4 + 1];
    const double aw = dt[i * 4 + 2], ah = dt[i * 4 + 3];
    const double aarea = aw * ah;
    for (int64_t j = 0; j < ngt; ++j) {
      const double bx = gt[j * 4], by = gt[j * 4 + 1];
      const double bw = gt[j * 4 + 2], bh = gt[j * 4 + 3];
      const double barea = bw * bh;
      const double ix = std::min(ax + aw, bx + bw) - std::max(ax, bx);
      const double iy = std::min(ay + ah, by + bh) - std::max(ay, by);
      double v = 0.0;
      if (ix > 0 && iy > 0) {
        const double inter = ix * iy;
        const double denom =
            (gt_iscrowd && gt_iscrowd[j]) ? aarea : aarea + barea - inter;
        if (denom > 0) v = inter / denom;
      }
      iou[i * ngt + j] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// Merge (union or intersection) many RLEs over the same grid into a decoded
// mask buffer — used for crowd-merging polygon parts.
// ---------------------------------------------------------------------------
void rle_merge_decode(const uint32_t* counts, const int64_t* off,
                      const int64_t* len, int64_t n, int64_t h, int64_t w,
                      uint8_t* out) {
  const int64_t size = h * w;
  std::memset(out, 0, static_cast<size_t>(size));
  std::vector<uint8_t> tmp(static_cast<size_t>(size));
  for (int64_t k = 0; k < n; ++k) {
    rle_decode(counts + off[k], len[k], h, w, tmp.data());
    for (int64_t i = 0; i < size; ++i) out[i] |= tmp[i];
  }
}

// ---------------------------------------------------------------------------
// Rasterize a polygon (COCO [x0,y0,x1,y1,...] convention) into a
// column-major mask using the pycocotools boundary-following approach's
// observable behavior: pixel (r, c) is inside if its center-ish sample is
// within the polygon. We use standard even-odd scanline fill at pixel
// centers offset like pycocotools (which rounds vertices to a 1/scale grid;
// empirically center sampling matches on real annotations to sub-pixel).
// ---------------------------------------------------------------------------
void poly_rasterize(const double* xy, int64_t nvert, int64_t h, int64_t w,
                    uint8_t* mask /* column-major h*w */) {
  std::memset(mask, 0, static_cast<size_t>(h * w));
  if (nvert < 3) return;
  std::vector<double> xs(nvert), ys(nvert);
  for (int64_t i = 0; i < nvert; ++i) {
    xs[i] = xy[2 * i];
    ys[i] = xy[2 * i + 1];
  }
  std::vector<double> inter;
  inter.reserve(static_cast<size_t>(nvert));
  for (int64_t r = 0; r < h; ++r) {
    const double py = r + 0.5;
    inter.clear();
    for (int64_t i = 0; i < nvert; ++i) {
      const int64_t j = (i + 1) % nvert;
      const double y0 = ys[i], y1 = ys[j];
      if ((y0 <= py && y1 > py) || (y1 <= py && y0 > py)) {
        const double t = (py - y0) / (y1 - y0);
        inter.push_back(xs[i] + t * (xs[j] - xs[i]));
      }
    }
    std::sort(inter.begin(), inter.end());
    for (size_t k = 0; k + 1 < inter.size(); k += 2) {
      int64_t c0 = static_cast<int64_t>(std::ceil(inter[k] - 0.5));
      int64_t c1 = static_cast<int64_t>(std::floor(inter[k + 1] - 0.5));
      c0 = std::max<int64_t>(c0, 0);
      c1 = std::min<int64_t>(c1, w - 1);
      for (int64_t c = c0; c <= c1; ++c) mask[c * h + r] = 1;
    }
  }
}

}  // extern "C"
