// Native toy-data generator of hint_tpu_torch (a copy of
// hint_tpu/native/geometry.cc, built into this package's own library).
//
// The reference generates its Fourier-curve datasets and the 1e8-sample
// ABC prior sweep in per-sample Python loops (shapely geometry +
// numpy DFT; data.py:85-100,188-227, rejection_sampling.py:76-85 of the
// reference). This library implements the same pipeline — circle-intersection lens
// shapes, rectangle-union plus shapes, polyline densification, DFT
// coefficients, forward processes — in C++ for the host side of the
// framework. Geometry matches the Python implementation
// (hint_tpu_torch/data/geometry.py, hint_tpu_torch/data/fourier.py) to ~1e-9 given
// the same inputs (tests/test_torch_port_eval.py); the batch samplers
// use their own RNG stream (std::mt19937_64), so they match the numpy
// path in distribution, not sample-for-sample.
//
// Exposed via a plain C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <complex>
#include <cstdint>
#include <random>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

constexpr double kPi = 3.14159265358979323846;

double ring_area(const std::vector<Pt>& p) {
  double a = 0;
  for (size_t i = 0; i < p.size(); ++i) {
    const Pt& u = p[i];
    const Pt& v = p[(i + 1) % p.size()];
    a += u.x * v.y - v.x * u.y;
  }
  return 0.5 * a;
}

void ensure_ccw(std::vector<Pt>& p) {
  if (ring_area(p) < 0) std::reverse(p.begin(), p.end());
}

std::vector<Pt> circle_polygon(double cx, double cy, double r, int resolution = 16) {
  int n = 4 * resolution;
  std::vector<Pt> out(n);
  for (int k = 0; k < n; ++k) {
    double th = 2.0 * kPi * k / n;
    out[k] = {cx + r * std::cos(th), cy + r * std::sin(th)};
  }
  return out;
}

// Sutherland–Hodgman, semantics identical to
// hint_tpu_torch/data/geometry.py::convex_intersection (>= 0 is inside).
std::vector<Pt> convex_intersection(std::vector<Pt> subject, std::vector<Pt> clip) {
  ensure_ccw(clip);
  ensure_ccw(subject);
  std::vector<Pt> pts = std::move(subject);
  std::vector<Pt> next;
  for (size_t i = 0; i < clip.size() && !pts.empty(); ++i) {
    const Pt a = clip[i];
    const Pt b = clip[(i + 1) % clip.size()];
    const double ex = b.x - a.x, ey = b.y - a.y;
    next.clear();
    Pt prev = pts.back();
    bool prev_in = ex * (prev.y - a.y) - ey * (prev.x - a.x) >= 0;
    for (const Pt& cur : pts) {
      bool cur_in = ex * (cur.y - a.y) - ey * (cur.x - a.x) >= 0;
      if (cur_in != prev_in) {
        double dx = cur.x - prev.x, dy = cur.y - prev.y;
        double denom = ex * dy - ey * dx;
        double t = (ex * (a.y - prev.y) - ey * (a.x - prev.x)) / denom;
        next.push_back({prev.x + t * dx, prev.y + t * dy});
      }
      if (cur_in) next.push_back(cur);
      prev = cur;
      prev_in = cur_in;
    }
    pts = next;
  }
  return pts;
}

// Rectangle-union outline, logic mirroring
// hint_tpu_torch/data/geometry.py::rect_union_outline.
struct Rect {
  double x0, y0, x1, y1;
};

bool strictly_inside(const Pt& p, const Rect& r) {
  return r.x0 + 1e-12 < p.x && p.x < r.x1 - 1e-12 && r.y0 + 1e-12 < p.y &&
         p.y < r.y1 - 1e-12;
}

void rect_corners(const Rect& r, Pt c[4]) {
  c[0] = {r.x0, r.y0};
  c[1] = {r.x1, r.y0};
  c[2] = {r.x1, r.y1};
  c[3] = {r.x0, r.y1};
}

bool seg_param(const Pt& p0, const Pt& p1, const Pt& q0, const Pt& q1, double* t_out) {
  double dx = p1.x - p0.x, dy = p1.y - p0.y;
  double ex = q1.x - q0.x, ey = q1.y - q0.y;
  double denom = dx * ey - dy * ex;
  if (std::fabs(denom) < 1e-12) return false;
  double wx = q0.x - p0.x, wy = q0.y - p0.y;
  double t = (wx * ey - wy * ex) / denom;
  double u = (wx * dy - wy * dx) / denom;
  if (t > -1e-12 && t < 1 + 1e-12 && u > -1e-12 && u < 1 + 1e-12) {
    *t_out = std::min(std::max(t, 0.0), 1.0);
    return true;
  }
  return false;
}

std::vector<Pt> rect_union_outline(const Rect& ra, const Rect& rb) {
  std::vector<std::pair<Pt, Pt>> segments;
  const Rect* rects[2][2] = {{&ra, &rb}, {&rb, &ra}};
  for (auto& pair : rects) {
    const Rect& rect = *pair[0];
    const Rect& other = *pair[1];
    Pt corners[4], ocorners[4];
    rect_corners(rect, corners);
    rect_corners(other, ocorners);
    for (int i = 0; i < 4; ++i) {
      Pt s = corners[i], e = corners[(i + 1) % 4];
      std::vector<double> ts = {0.0, 1.0};
      for (int j = 0; j < 4; ++j) {
        double t;
        if (seg_param(s, e, ocorners[j], ocorners[(j + 1) % 4], &t)) ts.push_back(t);
      }
      std::sort(ts.begin(), ts.end());
      ts.erase(std::unique(ts.begin(), ts.end(),
                           [](double a, double b) { return std::fabs(a - b) < 1e-15; }),
               ts.end());
      for (size_t k = 0; k + 1 < ts.size(); ++k) {
        double t0 = ts[k], t1 = ts[k + 1];
        if (t1 - t0 < 1e-12) continue;
        Pt mid = {s.x + 0.5 * (t0 + t1) * (e.x - s.x), s.y + 0.5 * (t0 + t1) * (e.y - s.y)};
        if (!strictly_inside(mid, other)) {
          segments.push_back({{s.x + t0 * (e.x - s.x), s.y + t0 * (e.y - s.y)},
                              {s.x + t1 * (e.x - s.x), s.y + t1 * (e.y - s.y)}});
        }
      }
    }
  }
  std::vector<Pt> ring;
  if (segments.empty()) {
    Pt c[4];
    rect_corners(ra, c);
    ring.assign(c, c + 4);
    return ring;
  }
  std::vector<bool> used(segments.size(), false);
  ring.push_back(segments[0].first);
  ring.push_back(segments[0].second);
  used[0] = true;
  for (size_t step = 1; step < segments.size(); ++step) {
    const Pt cur = ring.back();
    int best = -1;
    double best_d = 1e-9;
    for (size_t k = 0; k < segments.size(); ++k) {
      if (used[k]) continue;
      double d = std::fabs(segments[k].first.x - cur.x) + std::fabs(segments[k].first.y - cur.y);
      if (d < best_d) {
        best = static_cast<int>(k);
        best_d = d;
      }
    }
    if (best < 0) break;
    used[best] = true;
    ring.push_back(segments[best].second);
  }
  // drop closing duplicate + consecutive repeats
  if (!ring.empty() && std::fabs(ring.front().x - ring.back().x) < 1e-9 &&
      std::fabs(ring.front().y - ring.back().y) < 1e-9)
    ring.pop_back();
  std::vector<Pt> dedup;
  for (const Pt& p : ring) {
    if (dedup.empty() || std::fabs(p.x - dedup.back().x) > 1e-9 ||
        std::fabs(p.y - dedup.back().y) > 1e-9)
      dedup.push_back(p);
  }
  ensure_ccw(dedup);
  return dedup;
}

// densify_polyline (hint_tpu_torch/data/fourier.py:187-197): edge i runs from
// coords[(i+1)%n] (start) back to coords[i] (end), via ts in [0, 1].
std::vector<Pt> densify(const std::vector<Pt>& coords, double max_dist) {
  std::vector<Pt> out;
  size_t n = coords.size();
  for (size_t i = 0; i < n; ++i) {
    Pt start = coords[(i + 1) % n];
    Pt end = coords[i];
    double m = std::max(std::fabs(end.x - start.x), std::fabs(end.y - start.y));
    long k = std::lround(m / max_dist);
    if (k < 1) k = 1;
    for (long j = 0; j < k; ++j) {
      double t = (k == 1) ? 0.0 : static_cast<double>(j) / (k - 1);
      out.push_back({t * start.x + (1 - t) * end.x, t * start.y + (1 - t) * end.y});
    }
  }
  return out;
}

// DFT coefficients, m = -M..M (fourier.py:52-65). points may include a
// closing duplicate (the lens path does, matching the Python pipeline).
void fourier_coeffs(const std::vector<Pt>& pts, int M, std::complex<double>* cx,
                    std::complex<double>* cy) {
  size_t n = pts.size();
  for (int mi = -M; mi <= M; ++mi) {
    std::complex<double> ax(0, 0), ay(0, 0);
    for (size_t k = 0; k < n; ++k) {
      double ph = -2.0 * kPi * mi * static_cast<double>(k) / n;
      std::complex<double> w(std::cos(ph), std::sin(ph));
      ax += pts[k].x * w;
      ay += pts[k].y * w;
    }
    cx[mi + M] = ax / static_cast<double>(n);
    cy[mi + M] = ay / static_cast<double>(n);
  }
}

// trace curve at n_points (fourier.py:67-75)
void trace_curve(const std::complex<double>* cx, const std::complex<double>* cy, int M,
                 int n_points, std::vector<Pt>& out) {
  out.resize(n_points);
  for (int i = 0; i < n_points; ++i) {
    double t = (n_points == 1) ? 0.0 : static_cast<double>(i) / (n_points - 1);
    std::complex<double> px(0, 0), py(0, 0);
    for (int mi = -M; mi <= M; ++mi) {
      double ph = 2.0 * kPi * mi * t;
      std::complex<double> w(std::cos(ph), std::sin(ph));
      px += cx[mi + M] * w;
      py += cy[mi + M] * w;
    }
    out[i] = {px.real(), py.real()};
  }
}

struct Rng {
  std::mt19937_64 gen;
  std::uniform_real_distribution<double> unif{0.0, 1.0};
  std::normal_distribution<double> norm{0.0, 1.0};
  explicit Rng(uint64_t seed) : gen(seed) {}
  double u() { return unif(gen); }
  double n() { return norm(gen); }
};

// flatten_coeffs layout (fourier.py:40-43): x-coeff reals, y-coeff reals,
// x-coeff imags, y-coeff imags — i.e. real part of the (2, 2M+1) block then
// imaginary part.
void flatten(const std::complex<double>* cx, const std::complex<double>* cy, int M,
             double* out) {
  int k = 2 * M + 1;
  for (int i = 0; i < k; ++i) out[i] = cx[i].real();
  for (int i = 0; i < k; ++i) out[k + i] = cy[i].real();
  for (int i = 0; i < k; ++i) out[2 * k + i] = cx[i].imag();
  for (int i = 0; i < k; ++i) out[3 * k + i] = cy[i].imag();
}

void lens_one(Rng& rng, double* out_x, double* out_y) {
  // generate_lens_shape (fourier.py:95-109 / reference data.py:85-100)
  double r0 = 1.0 + rng.u();
  auto c0 = circle_polygon(0, 0, r0);
  double r1 = 2.0 * r0;
  double theta = 2.0 * kPi * rng.u();
  double d = 0.8 * (r0 + r1);
  auto c1 = circle_polygon(d * std::sin(theta), d * std::cos(theta), r1);
  auto ring = convex_intersection(c0, c1);
  ring.push_back(ring.front());  // close like shapely exterior.coords
  double mx = 0, my = 0;
  for (const Pt& p : ring) {
    mx += p.x;
    my += p.y;
  }
  mx /= ring.size();
  my /= ring.size();
  double ox = mx + 0.5 * rng.n(), oy = my + 0.5 * rng.n();
  for (Pt& p : ring) {
    p.x -= ox;
    p.y -= oy;
  }
  constexpr int M = 2;  // 5 complex coeffs (n_parameters/4)
  std::complex<double> cx[2 * M + 1], cy[2 * M + 1];
  fourier_coeffs(ring, M, cx, cy);
  flatten(cx, cy, M, out_x);
  // forward_process (fourier.py:130-142): most distant pair on the traced
  // curve, first max in row-major order, y = (dy, dx) + 0.05 N(0,1)
  std::vector<Pt> traced;
  trace_curve(cx, cy, M, 100, traced);
  double best = -1;
  int bi = 0, bj = 0;
  for (int i = 0; i < 100; ++i)
    for (int j = 0; j < 100; ++j) {
      double dx = traced[i].x - traced[j].x, dy = traced[i].y - traced[j].y;
      double dist = dx * dx + dy * dy;
      if (dist > best) {
        best = dist;
        bi = i;
        bj = j;
      }
    }
  out_y[0] = (traced[bj].y - traced[bi].y) + 0.05 * rng.n();
  out_y[1] = (traced[bj].x - traced[bi].x) + 0.05 * rng.n();
}

// target: nullptr for unconditional, else (center_x, center_y, angle, ratio)
// — the target-conditioned widths/angle of data.py:196-203.
void plus_one(Rng& rng, double* out_x, double* out_y, const double* target = nullptr) {
  double xlength = 3 + 2 * rng.u();
  double ylength = 3 + 2 * rng.u();
  double xwidth, ywidth;
  if (target == nullptr) {
    xwidth = 0.5 + 1.5 * rng.u();
    ywidth = 0.5 + 1.5 * rng.u();
  } else {
    double ratio = target[3];
    if (ratio >= 1.0)
      xwidth = ratio * 0.5 + (2.0 - ratio * 0.5) * rng.u();
    else
      xwidth = 0.5 + (2.0 * ratio - 0.5) * rng.u();
    ywidth = xwidth / ratio;
  }
  double xshift = -1.5 + 3 * rng.u();
  double yshift = -1.5 + 3 * rng.u();
  Rect xbar = {xshift - xlength / 2, -xwidth / 2, xshift + xlength / 2, xwidth / 2};
  Rect ybar = {-ywidth / 2, yshift - ylength / 2, ywidth / 2, yshift + ylength / 2};
  auto ring = rect_union_outline(xbar, ybar);
  auto dense = densify(ring, 0.2);
  double mx = 0, my = 0;
  for (const Pt& p : dense) {
    mx += p.x;
    my += p.y;
  }
  mx /= dense.size();
  my /= dense.size();
  double cx0 = -mx, cy0 = -my;  // center tracks -mean
  for (Pt& p : dense) {
    p.x -= mx;
    p.y -= my;
  }
  double angle = (target == nullptr) ? 0.5 * kPi * rng.u() : target[2];
  double ca = std::cos(angle), sa = std::sin(angle);
  // rotation matrix [[c, s], [-s, c]], row-vector action (fourier.py:186-189)
  for (Pt& p : dense) {
    double nx = p.x * ca - p.y * sa;
    double ny = p.x * sa + p.y * ca;
    p.x = nx;
    p.y = ny;
  }
  double ncx = cx0 * ca - cy0 * sa, ncy = cx0 * sa + cy0 * ca;
  double offx = 0.5 * rng.n(), offy = 0.5 * rng.n();
  for (Pt& p : dense) {
    p.x += offx;
    p.y += offy;
  }
  ncx += offx;
  ncy += offy;
  constexpr int M = 12;  // 25 complex coeffs
  std::complex<double> fx[2 * M + 1], fy[2 * M + 1];
  fourier_coeffs(dense, M, fx, fy);
  flatten(fx, fy, M, out_x);
  out_y[0] = ncx;
  out_y[1] = ncy;
  out_y[2] = angle;
  out_y[3] = xwidth / ywidth;
}

}  // namespace

extern "C" {

// Granular entry points for geometry parity tests --------------------------

// lens ring for given circle params; returns number of points written
// (x0,y0,r0) subject circle, (x1,y1,r1) clip circle; out has capacity cap*2
int hint_lens_ring(double x0, double y0, double r0, double x1, double y1, double r1,
                   double* out, int cap) {
  auto ring = convex_intersection(circle_polygon(x0, y0, r0), circle_polygon(x1, y1, r1));
  int n = static_cast<int>(std::min<size_t>(ring.size(), cap));
  for (int i = 0; i < n; ++i) {
    out[2 * i] = ring[i].x;
    out[2 * i + 1] = ring[i].y;
  }
  return n;
}

// plus outline (pre-densify) for given bar params
int hint_plus_outline(double xlength, double ylength, double xwidth, double ywidth,
                      double xshift, double yshift, double* out, int cap) {
  Rect xbar = {xshift - xlength / 2, -xwidth / 2, xshift + xlength / 2, xwidth / 2};
  Rect ybar = {-ywidth / 2, yshift - ylength / 2, ywidth / 2, yshift + ylength / 2};
  auto ring = rect_union_outline(xbar, ybar);
  int n = static_cast<int>(std::min<size_t>(ring.size(), cap));
  for (int i = 0; i < n; ++i) {
    out[2 * i] = ring[i].x;
    out[2 * i + 1] = ring[i].y;
  }
  return n;
}

// Batch samplers ------------------------------------------------------------

void hint_lens_batch(uint64_t seed, int n, double* out_x /* n*20 */,
                     double* out_y /* n*2 */) {
  Rng rng(seed);
  for (int i = 0; i < n; ++i) lens_one(rng, out_x + 20 * i, out_y + 2 * i);
}

void hint_plus_batch(uint64_t seed, int n, double* out_x /* n*100 */,
                     double* out_y /* n*4 */) {
  Rng rng(seed);
  for (int i = 0; i < n; ++i) plus_one(rng, out_x + 100 * i, out_y + 4 * i);
}

// Target-conditioned rejection sampling for the plus-shape conditional
// ground truth (rejection_sampling.py:113-127): generate with the target's
// angle/ratio, accept when ||label - target|| < tol. Returns the number of
// accepted samples (== n unless max_trials was exhausted).
int hint_plus_conditional_batch(uint64_t seed, int n, const double* target, double tol,
                                long max_trials, double* out_x /* n*100 */,
                                double* out_y /* n*4 */) {
  Rng rng(seed);
  double x[100], y[4];
  int got = 0;
  for (long trial = 0; trial < max_trials && got < n; ++trial) {
    plus_one(rng, x, y, target);
    double d2 = 0;
    for (int k = 0; k < 4; ++k) d2 += (y[k] - target[k]) * (y[k] - target[k]);
    if (std::sqrt(d2) < tol) {
      std::copy(x, x + 100, out_x + 100 * got);
      std::copy(y, y + 4, out_y + 4 * got);
      ++got;
    }
  }
  return got;
}

}  // extern "C"
