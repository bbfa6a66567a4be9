// pdx host ops — native C++ implementations of the framework's core image and
// regression primitives.
//
// Role: the reference pipeline's performance-critical native surface was
// OpenCV C++ (warps, blurs) plus LAPACK (ridge solves). pdx's compute path is
// JAX/XLA on the GPU; this library is the host-native counterpart used as
//   1. an independent oracle for parity tests (no NumPy/JAX code shared), and
//   2. a dependency-free CPU fallback for host-side preprocessing.
//
// Plain C ABI for ctypes. Build: g++ -O2 -shared -fPIC (see pdx/native.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// bilinear warps
// ---------------------------------------------------------------------------

static inline int wrap_idx(int i, int n) {
  int m = i % n;
  return m < 0 ? m + n : m;
}

static inline int reflect101_idx(int i, int n) {
  if (n == 1) return 0;
  int period = 2 * (n - 1);
  int m = i % period;
  if (m < 0) m += period;
  return m >= n ? period - m : m;
}

// out[r, c] = bilinear(in, r - sx, c - sy) with periodic wrap
void shift_periodic_f64(const double* in, double* out, int h, int w, double sx,
                        double sy) {
  for (int r = 0; r < h; ++r) {
    double x = r - sx;
    int x0 = (int)std::floor(x);
    double tx = x - x0;
    int xa = wrap_idx(x0, h), xb = wrap_idx(x0 + 1, h);
    for (int c = 0; c < w; ++c) {
      double y = c - sy;
      int y0 = (int)std::floor(y);
      double ty = y - y0;
      int ya = wrap_idx(y0, w), yb = wrap_idx(y0 + 1, w);
      out[r * w + c] = in[xa * w + ya] * (1 - tx) * (1 - ty) +
                       in[xa * w + yb] * (1 - tx) * ty +
                       in[xb * w + ya] * tx * (1 - ty) +
                       in[xb * w + yb] * tx * ty;
    }
  }
}

void shift_reflect_f64(const double* in, double* out, int h, int w, double sx,
                       double sy) {
  for (int r = 0; r < h; ++r) {
    double x = r - sx;
    int x0 = (int)std::floor(x);
    double tx = x - x0;
    int xa = reflect101_idx(x0, h), xb = reflect101_idx(x0 + 1, h);
    for (int c = 0; c < w; ++c) {
      double y = c - sy;
      int y0 = (int)std::floor(y);
      double ty = y - y0;
      int ya = reflect101_idx(y0, w), yb = reflect101_idx(y0 + 1, w);
      out[r * w + c] = in[xa * w + ya] * (1 - tx) * (1 - ty) +
                       in[xa * w + yb] * (1 - tx) * ty +
                       in[xb * w + ya] * tx * (1 - ty) +
                       in[xb * w + yb] * tx * ty;
    }
  }
}

// ---------------------------------------------------------------------------
// separable Gaussian (scipy.ndimage.gaussian_filter semantics: truncate=4,
// radius = int(truncate*sigma + 0.5), 'reflect' = symmetric padding)
// ---------------------------------------------------------------------------

void gaussian_blur_reflect_f64(const double* in, double* out, int h, int w,
                               double sigma) {
  if (sigma <= 0) {
    std::memcpy(out, in, sizeof(double) * h * w);
    return;
  }
  int radius = (int)(4.0 * sigma + 0.5);
  std::vector<double> k(2 * radius + 1);
  double ssum = 0;
  for (int i = -radius; i <= radius; ++i) {
    k[i + radius] = std::exp(-0.5 * i * i / (sigma * sigma));
    ssum += k[i + radius];
  }
  for (auto& v : k) v /= ssum;

  auto sym = [](int i, int n) {
    // scipy 'reflect': (d c b a | a b c d | d c b a) — period 2n
    int period = 2 * n;
    int m = i % period;
    if (m < 0) m += period;
    return m < n ? m : period - 1 - m;
  };

  std::vector<double> tmp((size_t)h * w);
  for (int r = 0; r < h; ++r)
    for (int c = 0; c < w; ++c) {
      double acc = 0;
      for (int i = -radius; i <= radius; ++i)
        acc += k[i + radius] * in[sym(r + i, h) * w + c];
      tmp[r * w + c] = acc;
    }
  for (int r = 0; r < h; ++r)
    for (int c = 0; c < w; ++c) {
      double acc = 0;
      for (int i = -radius; i <= radius; ++i)
        acc += k[i + radius] * tmp[r * w + sym(c + i, w)];
      out[r * w + c] = acc;
    }
}

// ---------------------------------------------------------------------------
// blockwise mean dataset (mean of y and each of p term fields over
// (bt, bx, by) blocks). Shapes: y (T,H,W); terms (p,T,H,W). Outputs row-major
// (n_blocks, p) X and (n_blocks) yout; returns n_blocks.
// ---------------------------------------------------------------------------

int blockwise_mean_f64(const double* yfield, const double* terms, int p, int T,
                       int H, int W, int bt, int bx, int by, double* Xout,
                       double* yout) {
  int nb = 0;
  for (int t0 = 0; t0 < T; t0 += bt)
    for (int x0 = 0; x0 < H; x0 += bx)
      for (int y0 = 0; y0 < W; y0 += by) {
        int t1 = std::min(T, t0 + bt), x1 = std::min(H, x0 + bx),
            y1 = std::min(W, y0 + by);
        double cnt = (double)(t1 - t0) * (x1 - x0) * (y1 - y0);
        double acc = 0;
        for (int t = t0; t < t1; ++t)
          for (int x = x0; x < x1; ++x)
            for (int y = y0; y < y1; ++y)
              acc += yfield[((size_t)t * H + x) * W + y];
        yout[nb] = acc / cnt;
        for (int j = 0; j < p; ++j) {
          double a = 0;
          const double* f = terms + (size_t)j * T * H * W;
          for (int t = t0; t < t1; ++t)
            for (int x = x0; x < x1; ++x)
              for (int y = y0; y < y1; ++y) a += f[((size_t)t * H + x) * W + y];
          Xout[(size_t)nb * p + j] = a / cnt;
        }
        ++nb;
      }
  return nb;
}

// ---------------------------------------------------------------------------
// STRidge (reference semantics: standardize -> ridge -> threshold loop ->
// refit on support -> unscale by /(scale + 1e-12)). Gauss-Jordan solve.
// ---------------------------------------------------------------------------

static bool solve_inplace(std::vector<double>& A, std::vector<double>& b, int n) {
  for (int col = 0; col < n; ++col) {
    int piv = col;
    for (int r = col + 1; r < n; ++r)
      if (std::fabs(A[r * n + col]) > std::fabs(A[piv * n + col])) piv = r;
    if (std::fabs(A[piv * n + col]) < 1e-300) return false;
    if (piv != col) {
      for (int c = 0; c < n; ++c) std::swap(A[col * n + c], A[piv * n + c]);
      std::swap(b[col], b[piv]);
    }
    double d = A[col * n + col];
    for (int c = 0; c < n; ++c) A[col * n + c] /= d;
    b[col] /= d;
    for (int r = 0; r < n; ++r) {
      if (r == col) continue;
      double f = A[r * n + col];
      if (f == 0) continue;
      for (int c = 0; c < n; ++c) A[r * n + c] -= f * A[col * n + c];
      b[r] -= f * b[col];
    }
  }
  return true;
}

void stridge_f64(const double* X, const double* y, int n, int p, double alpha,
                 double threshold, int max_iter, double* coeffs_out) {
  // column standardization
  std::vector<double> mean(p, 0), scale(p, 0);
  for (int j = 0; j < p; ++j) {
    double m = 0;
    for (int i = 0; i < n; ++i) m += X[(size_t)i * p + j];
    m /= n;
    double v = 0;
    for (int i = 0; i < n; ++i) {
      double d = X[(size_t)i * p + j] - m;
      v += d * d;
    }
    mean[j] = m;
    double s = std::sqrt(v / n);
    scale[j] = s > 0 ? s : 1.0;
  }

  // standardized Gram + moment
  std::vector<double> G((size_t)p * p, 0), bm(p, 0);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < p; ++j) {
      double xj = (X[(size_t)i * p + j] - mean[j]) / scale[j];
      bm[j] += xj * y[i];
      for (int k = j; k < p; ++k) {
        double xk = (X[(size_t)i * p + k] - mean[k]) / scale[k];
        G[(size_t)j * p + k] += xj * xk;
      }
    }
  }
  for (int j = 0; j < p; ++j)
    for (int k = 0; k < j; ++k) G[(size_t)j * p + k] = G[(size_t)k * p + j];

  std::vector<int> active(p, 1);
  std::vector<double> c(p, 0);

  auto refit = [&](void) {
    std::vector<int> idx;
    for (int j = 0; j < p; ++j)
      if (active[j]) idx.push_back(j);
    int m = (int)idx.size();
    if (m == 0) {
      std::fill(c.begin(), c.end(), 0.0);
      return;
    }
    std::vector<double> A((size_t)m * m), rhs(m);
    for (int a = 0; a < m; ++a) {
      rhs[a] = bm[idx[a]];
      for (int b2 = 0; b2 < m; ++b2)
        A[(size_t)a * m + b2] = G[(size_t)idx[a] * p + idx[b2]] + (a == b2 ? alpha : 0.0);
    }
    solve_inplace(A, rhs, m);
    std::fill(c.begin(), c.end(), 0.0);
    for (int a = 0; a < m; ++a) c[idx[a]] = rhs[a];
  };

  refit();
  for (int it = 0; it < max_iter; ++it) {
    bool all_small = true;
    for (int j = 0; j < p; ++j)
      if (std::fabs(c[j]) >= threshold) all_small = false;
    if (all_small) {
      std::fill(c.begin(), c.end(), 0.0);
      break;
    }
    for (int j = 0; j < p; ++j)
      if (std::fabs(c[j]) < threshold) active[j] = 0;
    refit();
  }
  for (int j = 0; j < p; ++j) coeffs_out[j] = c[j] / (scale[j] + 1e-12);
}

}  // extern "C"
