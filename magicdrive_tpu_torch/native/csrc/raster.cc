// Host-side BEV raster core of the port (the scanline core of the JAX
// package's native/csrc/raster.cc): the native counterpart of the PIL
// ImageDraw calls in magicdrive_tpu_torch/data/map_raster.py
// (ref:magicdrive/dataset/pipeline.py:176-306).
//
// Semantics: a pixel (x, y) is filled iff the integer grid point (x, y)
// lies inside or on the boundary of the polygon — scanline even-odd parity
// spans plus Bresenham-drawn edges. Vertices are integers (the data path
// rounds before drawing).
//
// Plain C ABI, built with g++ at first use and bound via ctypes
// (magicdrive_tpu_torch/native/raster.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

inline void set_px(uint8_t* canvas, int h, int w, int x, int y,
                   uint8_t value) {
  if (x >= 0 && x < w && y >= 0 && y < h)
    canvas[static_cast<int64_t>(y) * w + x] = value;
}

inline void hline(uint8_t* canvas, int h, int w, int x0, int x1, int y,
                  uint8_t value) {
  if (y < 0 || y >= h) return;
  x0 = std::max(x0, 0);
  x1 = std::min(x1, w - 1);
  if (x1 < x0) return;
  uint8_t* row = canvas + static_cast<int64_t>(y) * w;
  std::fill(row + x0, row + x1 + 1, value);
}


}  // namespace

extern "C" {

inline int round_half_up(double f) {
  return static_cast<int>(std::floor(f + 0.5));
}

inline int round_half_down(double f) {
  return static_cast<int>(std::ceil(f - 0.5));
}

// xy: (n, 2) int32 vertices (closed implicitly). canvas: (h, w) uint8.
//
// Scanline algorithm reconstructed from PIL's polygon_generic behavior
// (pixel-exact on simple polygons, held to the JAX package's core in
// tests/test_torch_port_data.py): per integer scanline y, every
// non-horizontal edge with ymin <= y <= ymax contributes its intersection
// x(y); an edge whose ymax == y additionally duplicates the value unless y
// is the scan bottom (this keeps spans paired across vertex rows); sorted
// values are filled pairwise with inclusive hlines whose left end rounds
// half up and right end rounds half down.
// Horizontal edges are hlined directly.
void fill_polygon_u8(uint8_t* canvas, int32_t h, int32_t w,
                     const int32_t* xy, int32_t n, uint8_t value) {
  if (n == 0) return;
  if (n == 1) { set_px(canvas, h, w, xy[0], xy[1], value); return; }

  int poly_ymin = xy[1], poly_ymax = xy[1];
  for (int i = 1; i < n; ++i) {
    poly_ymin = std::min(poly_ymin, xy[2 * i + 1]);
    poly_ymax = std::max(poly_ymax, xy[2 * i + 1]);
  }
  // scan the full polygon extent (hline clips per row): the span-pairing
  // duplication rule below must see the true polygon bottom, not the canvas
  const int y_lo = poly_ymin;
  const int y_hi = poly_ymax;

  for (int i = 0; i < n; ++i) {  // horizontal edges
    const int j = (i + 1) % n;
    if (xy[2 * i + 1] == xy[2 * j + 1]) {
      hline(canvas, h, w, std::min(xy[2 * i], xy[2 * j]),
            std::max(xy[2 * i], xy[2 * j]), xy[2 * i + 1], value);
    }
  }

  std::vector<double> xs;
  for (int y = y_lo; y <= y_hi; ++y) {
    xs.clear();
    for (int i = 0; i < n; ++i) {
      const int j = (i + 1) % n;
      const int x0 = xy[2 * i], y0 = xy[2 * i + 1];
      const int x1 = xy[2 * j], y1 = xy[2 * j + 1];
      if (y0 == y1) continue;
      const int lo = std::min(y0, y1), hi = std::max(y0, y1);
      if (y < lo || y > hi) continue;
      const double x =
          x0 + static_cast<double>(y - y0) * (x1 - x0) / (y1 - y0);
      xs.push_back(x);
      if (y == hi && y < poly_ymax) xs.push_back(x);
    }
    std::sort(xs.begin(), xs.end());
    for (size_t k = 0; k + 1 < xs.size(); k += 2) {
      hline(canvas, h, w, round_half_up(xs[k]),
            round_half_down(xs[k + 1]), y, value);
    }
  }
}

// Aux BEV channels for box footprints (ref:magicdrive/dataset/pipeline.py:
// 88-174 via magicdrive_tpu_torch/data/map_raster.py aux_masks): for each box,
// rasterize its bottom-face quad and write per-pixel visibility /
// center-offset / center-ohw / height channels. Boxes processed in order
// (later boxes overwrite). Corner rounding uses round-half-to-even to match
// numpy's np.round.
//
// aux: (h, w, c) float32, c = has_* channel sum; bc: (n, 4, 2) float64
// canvas-space bottom corners (draw order 0,3,7,4 of the mmdet3d box).
void aux_channels_f32(float* aux, int32_t h, int32_t w, int32_t c,
                      const double* bc, const double* vis,
                      const double* height, int32_t n, int32_t has_vis,
                      int32_t has_offset, int32_t has_ohw,
                      int32_t has_height) {
  std::vector<uint8_t> scratch;
  for (int32_t i = 0; i < n; ++i) {
    const double* q = bc + static_cast<int64_t>(i) * 8;  // 4 corners x 2
    int32_t pts[8];
    for (int k = 0; k < 8; ++k)
      pts[k] = static_cast<int32_t>(std::nearbyint(q[k]));
    int x0 = std::min(std::min(pts[0], pts[2]), std::min(pts[4], pts[6]));
    int x1 = std::max(std::max(pts[0], pts[2]), std::max(pts[4], pts[6]));
    int y0 = std::min(std::min(pts[1], pts[3]), std::min(pts[5], pts[7]));
    int y1 = std::max(std::max(pts[1], pts[3]), std::max(pts[5], pts[7]));
    x0 = std::max(x0, 0); y0 = std::max(y0, 0);
    x1 = std::min(x1, w - 1); y1 = std::min(y1, h - 1);
    if (x1 < x0 || y1 < y0) continue;
    const int rw = x1 - x0 + 1, rh = y1 - y0 + 1;
    scratch.assign(static_cast<size_t>(rw) * rh, 0);
    int32_t shifted[8];
    for (int k = 0; k < 4; ++k) {
      shifted[2 * k] = pts[2 * k] - x0;
      shifted[2 * k + 1] = pts[2 * k + 1] - y0;
    }
    fill_polygon_u8(scratch.data(), rh, rw, shifted, 4, 1);

    const double cx = (q[0] + q[2] + q[4] + q[6]) / 4.0;
    const double cy = (q[1] + q[3] + q[5] + q[7]) / 4.0;
    const double fx = (q[4] + q[6]) / 2.0, fy = (q[5] + q[7]) / 2.0;
    const double lx = (q[0] + q[6]) / 2.0, ly = (q[1] + q[7]) / 2.0;
    const double hgt = std::hypot(fx - cx, fy - cy);
    const double wdt = std::hypot(lx - cx, ly - cy);
    const double vx = (fx - cx) / (hgt + 1e-6);
    const double vy = (fy - cy) / (hgt + 1e-6);

    for (int yy = 0; yy < rh; ++yy) {
      for (int xx = 0; xx < rw; ++xx) {
        if (!scratch[static_cast<size_t>(yy) * rw + xx]) continue;
        float* px =
            aux + (static_cast<int64_t>(y0 + yy) * w + (x0 + xx)) * c;
        int cur = 0;
        if (has_vis) px[cur++] = static_cast<float>(vis[i]);
        if (has_offset) {
          px[cur++] = static_cast<float>((x0 + xx) - cx);
          px[cur++] = static_cast<float>((y0 + yy) - cy);
        }
        if (has_ohw) {
          px[cur++] = static_cast<float>(hgt);
          px[cur++] = static_cast<float>(wdt);
          px[cur++] = static_cast<float>(vx);
          px[cur++] = static_cast<float>(vy);
        }
        if (has_height) px[cur++] = static_cast<float>(height[i]);
      }
    }
  }
}

// Polyline with the 2-px band convention of the map data path
// (ref devkit mask_for_lines: cv2.polylines thickness=2): each segment is
// drawn as a filled quad offset perpendicular by [0, +1] pixels — for
// axis-aligned segments this fills rows y..y+1 / cols x..x+1, matching
// PIL width=2.
void draw_polyline2_u8(uint8_t* canvas, int32_t h, int32_t w,
                       const int32_t* xy, int32_t n, uint8_t value) {
  for (int i = 0; i + 1 < n; ++i) {
    const int x0 = xy[2 * i], y0 = xy[2 * i + 1];
    const int x1 = xy[2 * i + 2], y1 = xy[2 * i + 3];
    const int dx = std::abs(x1 - x0), dy = std::abs(y1 - y0);
    // offset axis: perpendicular to the dominant direction
    const int ox = dy > dx ? 1 : 0;
    const int oy = dy > dx ? 0 : 1;
    const int32_t quad[8] = {x0, y0, x1, y1, x1 + ox, y1 + oy, x0 + ox,
                             y0 + oy};
    fill_polygon_u8(canvas, h, w, quad, 4, value);
  }
  if (n == 1) set_px(canvas, h, w, xy[0], xy[1], value);
}

}  // extern "C"
