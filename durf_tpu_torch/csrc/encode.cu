// E1: the model's encodings in one pass each, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves its encodings to XLA,
// which fuses them. Eager PyTorch ran them as 100-170 elementwise launches
// a level, each reading and writing whole [B, S] planes, at about 5% of
// their bytes bound; this kernel does the same arithmetic in one pass.
// Three modes, each a plain composition of ops/encoding.py:
//
//   WINDOWED    windowed_ipe_cm: the mean's 3 planes, then the BARF-windowed
//               sin and cos planes of the IPE ([3 + F, N]; the object MLPs'
//               input). The window w_k = (1 - cos(pi clip(alpha - k, 0, 1)))
//               / 2 is formed in float32 in the kernel from alpha, a kernel
//               argument or a device pointer: no copy from the host.
//   BACKGROUND  the background's complement mask clamp(1 - sum_o hit_o, 0)
//               of each ray, contract_gaussian_diag, integrated_pos_enc_cm
//               ([F, N]; the background MLP's input). The masked and
//               contracted mean and variance stay in registers.
//   VIEW        pos_enc(viewdirs, 0, deg, append_identity=True): per ray
//               [B, 3 + 6 deg] rows, the powers of two made in the kernel.
//
// F = 6 (max_deg - min_deg), planes ordered (degree, coordinate), sin then
// cos. One thread per sample: it reads the sample's mean and variance once
// (coalesced plane loads), computes every feature in registers and writes
// each plane's word (coalesced plane stores). VIEW's rows are small (27
// features a ray): a thread per feature, so that its stores coalesce.
//
// Bound on the H100: bytes. A sample reads 24 B and writes 4 F B (240 B at
// F = 60, 252 B windowed): 0.55 GB a level and encoding at 16384 x 128
// samples, 0.17 ms at 3.35 TB/s. The work is 18 accurate transcendentals a
// sample (recurrent form), far below the card's rate.
//
// Same arithmetic as the plain composition on the card: every product, sum
// and quotient is rounded where PyTorch's elementwise kernels round it
// (__fmul_rn / __fadd_rn / __fdiv_rn, so nvcc contracts nothing into a
// fused multiply-add), with accurate sinf / cosf / expf / sqrtf; the
// recurrent form (e <- e^4, double-angle updates, a restart every RESTART
// degrees) and the direct form with mathx._safe_trig's range reduction are
// template flags. The reductions of the plain code over 3 coordinates
// ((a0 + a1) + a2, PyTorch's order for a reduction of 3) and over the
// objects' 0/1 hits (exact in any order) are written out.
//
// The backward (encode_bwd) recomputes the features from the inputs and
// applies the chain rule analytically: d/dx of w e sin(2^k x) is 2^k times
// the cos feature, d/dv is -4^k / 2 times the feature, then the
// contraction's Jacobian and the derivative of its row sums d, and the
// mask. It is used only where the mean, variance or view directions need a
// gradient (the pose-optimising configurations).

#include <cuda_runtime.h>
#include <math.h>

namespace durf {
namespace enc {

constexpr int WINDOWED = 0, BACKGROUND = 1, VIEW = 2;
constexpr int THREADS = 256;
constexpr int MAX_DEGS = 32;
constexpr int RESTART = 5;  // ops/encoding.py's _RESTART
// The Python constants as PyTorch casts them to float32.
constexpr float PI_F = (float)3.14159265358979323846;
constexpr float HALF_PI_F = (float)(0.5 * 3.14159265358979323846);
constexpr float TRIG_PERIOD_F = (float)(100.0 * 3.14159265358979323846);
constexpr float NORM_FLOOR = (float)1e-12;
constexpr float F32_MAX = 3.402823466e38f;

struct Args {
  const float* x;        // [3, n] mean planes, or [n, 3] view directions
  const float* v;        // [3, n] variance planes (null in VIEW)
  const float* hit;      // [n / s_per_ray, n_obj] 0/1, or null: no mask
  const float* alpha_p;  // device alpha, or null: alpha
  const float* g;        // backward: the output's cotangent, laid out as out
  float* out;            // forward output
  float* dx;             // backward: d mean (or d viewdirs)
  float* dv;             // backward: d variance
  long long n;           // samples (rays in VIEW)
  int n_obj, s_per_ray, min_deg, n_deg;
  float alpha, threshold;
};

__device__ __forceinline__ float clamp_min0(float v) { return isnan(v) ? v : fmaxf(v, 0.f); }

__device__ __forceinline__ float nan_to_num(float v) {
  return isnan(v) ? 0.f : (isinf(v) ? (v > 0.f ? F32_MAX : -F32_MAX) : v);
}

// torch.where(|y| < 100 pi, y, torch.remainder(y, 100 pi)).
__device__ __forceinline__ float safe_arg(float y) {
  if (fabsf(y) < TRIG_PERIOD_F) return y;
  float m = fmodf(y, TRIG_PERIOD_F);
  if (m != 0.f && ((TRIG_PERIOD_F < 0.f) != (m < 0.f))) m = __fadd_rn(m, TRIG_PERIOD_F);
  return m;
}

// barf_window's weight of degree k: (1 - cos(clamp(alpha - k, 0, 1) * pi)) / 2.
__device__ __forceinline__ float window(float alpha, int k) {
  float t = __fsub_rn(alpha, (float)k);
  if (!isnan(t)) t = fminf(fmaxf(t, 0.f), 1.f);
  return __fmul_rn(__fsub_rn(1.f, cosf(__fmul_rn(t, PI_F))), 0.5f);
}

// The IPE of one coordinate: emit(i, e sin, e cos) for degrees min_deg + i,
// i < n_deg, on the clamped variance v.
template <bool REC, bool SAFE, class Emit>
__device__ __forceinline__ void ipe(float x, float v, int min_deg, int n_deg, Emit&& emit) {
  float e = 0.f, s = 0.f, c = 0.f;
  for (int i = 0; i < n_deg; ++i) {
    const int deg = min_deg + i;
    const float scale = ldexpf(1.f, deg);
    const float k = -ldexpf(1.f, 2 * deg - 1);  // -0.5 * scale * scale, exact
    if (REC) {
      if (i % RESTART == 0) {
        e = expf(__fmul_rn(v, k));
        const float y = __fmul_rn(x, scale);
        s = sinf(y);
        c = cosf(y);
      }
      emit(i, __fmul_rn(e, s), __fmul_rn(e, c));
      const float e2 = __fmul_rn(e, e);
      e = __fmul_rn(e2, e2);
      const float s2 = __fmul_rn(__fmul_rn(2.f, s), c);
      c = __fsub_rn(__fmul_rn(c, c), __fmul_rn(s, s));
      s = s2;
    } else {
      const float y = __fmul_rn(x, scale);
      const float att = expf(__fmul_rn(v, k));
      float a = y, b = __fadd_rn(y, HALF_PI_F);
      if (SAFE) {
        a = safe_arg(a);
        b = safe_arg(b);
      }
      emit(i, __fmul_rn(att, sinf(a)), __fmul_rn(att, sinf(b)));
    }
  }
}

// The background's input for one sample: mask, then the contraction, as
// ops/contraction.py's _contract_with_row_sums computes it. Keeps what the
// backward needs.
struct Contracted {
  float m[3], v[3], d[3];  // contracted mean, variance, Jacobian row sums
  float x[3], vin[3];      // the masked input
  float sq, inv_n, sum;
  bool inside;
};

template <bool CONTRACT>
__device__ __forceinline__ void contract(Contracted& c, float threshold) {
  if (!CONTRACT) {
    for (int j = 0; j < 3; ++j) {
      c.m[j] = c.x[j];
      c.v[j] = c.vin[j];
      c.d[j] = 1.f;
    }
    return;
  }
  const float* x = c.x;
  c.sq = __fadd_rn(__fadd_rn(__fmul_rn(x[0], x[0]), __fmul_rn(x[1], x[1])), __fmul_rn(x[2], x[2]));
  const float n = sqrtf(isnan(c.sq) ? c.sq : fmaxf(c.sq, NORM_FLOOR));
  const float inside = n <= threshold ? 1.f : 0.f;
  c.inside = inside != 0.f;
  const float out = __fsub_rn(1.f, inside);
  const float inv_n = nan_to_num(__frcp_rn(n));
  c.inv_n = inv_n;
  c.sum = __fadd_rn(__fadd_rn(x[0], x[1]), x[2]);
  const float s = c.sq > NORM_FLOOR ? __fdiv_rn(c.sum, n) : 0.f;
  const float inv_n2 = __fmul_rn(inv_n, inv_n);
  const float shrink = __fmul_rn(out, __fsub_rn(2.f, inv_n));
  const float a = __fsub_rn(__fmul_rn(2.f, inv_n), inv_n2);
  for (int j = 0; j < 3; ++j) {
    const float unit = nan_to_num(__fdiv_rn(x[j], n));
    c.m[j] = __fadd_rn(__fmul_rn(inside, x[j]), __fmul_rn(shrink, unit));
    const float t = __fmul_rn(__fmul_rn(__fmul_rn(2.f, x[j]), s), inv_n2);
    const float d_out = __fadd_rn(__fsub_rn(a, t), __fmul_rn(t, inv_n));
    c.d[j] = __fadd_rn(inside, __fmul_rn(out, d_out));
    c.v[j] = __fmul_rn(__fmul_rn(c.d[j], c.d[j]), c.vin[j]);
  }
}

// The background's complement mask of sample i's ray.
__device__ __forceinline__ float bkgd_mask(const Args& a, long long i) {
  // 32-bit division where the samples fit (a 64-bit one is a subroutine).
  const long long ray = a.n <= 0x7fffffffLL ? (long long)((int)i / a.s_per_ray) : i / a.s_per_ray;
  const float* h = a.hit + ray * a.n_obj;
  float sum = 0.f;
  for (int o = 0; o < a.n_obj; ++o) sum = __fadd_rn(sum, h[o]);
  return clamp_min0(__fsub_rn(1.f, sum));
}

template <bool MASK, bool CONTRACT>
__device__ __forceinline__ void background_input(Contracted& c, const Args& a, long long i) {
  const float m = MASK ? bkgd_mask(a, i) : 1.f;
  for (int j = 0; j < 3; ++j) {
    const float x = a.x[j * a.n + i], v = a.v[j * a.n + i];
    c.x[j] = MASK ? __fmul_rn(m, x) : x;
    c.vin[j] = MASK ? __fmul_rn(m, v) : v;
  }
  contract<CONTRACT>(c, a.threshold);
}

__device__ __forceinline__ float alpha_of(const Args& a) {
  return a.alpha_p != nullptr ? *a.alpha_p : a.alpha;
}

template <int MODE, bool REC, bool SAFE, bool CONTRACT, bool MASK>
__global__ void __launch_bounds__(THREADS) encode_fwd(const Args a) {
  __shared__ float w[MAX_DEGS];
  if (MODE == WINDOWED) {
    const int t = threadIdx.x;
    if (t < a.n_deg) w[t] = window(alpha_of(a), a.min_deg + t);
    __syncthreads();
  }
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long n = a.n;
  const int nd = a.n_deg, cos0 = 3 * nd;
  if (MODE == VIEW) {  // a thread per output feature (rows of 3 + 6 nd, < 2^31 in all)
    const int width = 3 + cos0 + cos0;
    if (i >= n * width) return;
    const int r = (int)i / width, f = (int)i % width - 3;
    if (f < 0) {
      a.out[i] = a.x[r * 3 + f + 3];
      return;
    }
    const int fk = f % cos0;
    const float y = __fmul_rn(a.x[r * 3 + fk % 3], ldexpf(1.f, a.min_deg + fk / 3));
    a.out[i] = sinf(f < cos0 ? y : __fadd_rn(y, HALF_PI_F));
    return;
  }
  if (i >= n) return;
  if (MODE == WINDOWED) {
    for (int j = 0; j < 3; ++j) {
      const float x = a.x[j * n + i];
      a.out[j * n + i] = x;
      float* o = a.out + 3 * n;
      const float* wk = w;
      ipe<REC, SAFE>(x, clamp_min0(a.v[j * n + i]), a.min_deg, nd, [&](int k, float fs, float fc) {
        o[(k * 3 + j) * n + i] = __fmul_rn(wk[k], fs);
        o[(cos0 + k * 3 + j) * n + i] = __fmul_rn(wk[k], fc);
      });
    }
    return;
  }
  Contracted c;
  background_input<MASK, CONTRACT>(c, a, i);
  for (int j = 0; j < 3; ++j)
    ipe<REC, SAFE>(c.m[j], clamp_min0(c.v[j]), a.min_deg, nd, [&](int k, float fs, float fc) {
      a.out[(k * 3 + j) * n + i] = fs;
      a.out[(cos0 + k * 3 + j) * n + i] = fc;
    });
}

// d/d(x, v) of the (windowed) IPE of one coordinate from its cotangent
// planes gs(k), gc(k): (sum_k 2^k (gs F_c - gc F_s), sum_k -4^k/2 (gs F_s +
// gc F_c)), the variance's gradient zero where the clamp cut it.
template <bool REC, bool SAFE, class Window, class Cot>
__device__ __forceinline__ void ipe_vjp(float x, float v, int min_deg, int n_deg, Window&& wk,
                                        Cot&& cot, float& gx, float& gv) {
  float ax = 0.f, av = 0.f;
  ipe<REC, SAFE>(x, clamp_min0(v), min_deg, n_deg, [&](int k, float fs, float fc) {
    fs *= wk(k);
    fc *= wk(k);
    float gs, gc;
    cot(k, gs, gc);
    ax += ldexpf(gs * fc - gc * fs, min_deg + k);
    av -= ldexpf(gs * fs + gc * fc, 2 * (min_deg + k) - 1);
  });
  gx = ax;
  gv = v >= 0.f ? av : 0.f;
}

template <int MODE, bool REC, bool SAFE, bool CONTRACT, bool MASK>
__global__ void __launch_bounds__(THREADS) encode_bwd(const Args a) {
  __shared__ float w[MAX_DEGS];
  if (MODE == WINDOWED) {
    const int t = threadIdx.x;
    if (t < a.n_deg) w[t] = window(alpha_of(a), a.min_deg + t);
    __syncthreads();
  }
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long n = a.n;
  const int nd = a.n_deg, cos0 = 3 * nd;
  if (MODE == VIEW) {  // a thread per ray and coordinate
    if (i >= n * 3) return;
    const int r = (int)i / 3, j = (int)i % 3;
    const float* g = a.g + (long long)r * (3 + cos0 + cos0);
    const float x = a.x[i];
    float acc = 0.f;
    for (int k = 0; k < nd; ++k) {
      const float y = __fmul_rn(x, ldexpf(1.f, a.min_deg + k));
      const float t = g[3 + k * 3 + j] * cosf(y) +
                      g[3 + cos0 + k * 3 + j] * cosf(__fadd_rn(y, HALF_PI_F));
      acc += ldexpf(t, a.min_deg + k);
    }
    a.dx[i] = g[j] + acc;
    return;
  }
  if (i >= n) return;
  if (MODE == WINDOWED) {
    const float* g = a.g + 3 * n;
    const float* wk = w;
    for (int j = 0; j < 3; ++j) {
      float gx, gv;
      ipe_vjp<REC, SAFE>(
          a.x[j * n + i], a.v[j * n + i], a.min_deg, nd, [&](int k) { return wk[k]; },
          [&](int k, float& gs, float& gc) {
            gs = g[(k * 3 + j) * n + i];
            gc = g[(cos0 + k * 3 + j) * n + i];
          },
          gx, gv);
      a.dx[j * n + i] = a.g[j * n + i] + gx;
      a.dv[j * n + i] = gv;
    }
    return;
  }
  Contracted c;
  background_input<MASK, CONTRACT>(c, a, i);
  float gm[3], gvc[3];
  for (int j = 0; j < 3; ++j)
    ipe_vjp<REC, SAFE>(
        c.m[j], c.v[j], a.min_deg, nd, [](int) { return 1.f; },
        [&](int k, float& gs, float& gc) {
          gs = a.g[(k * 3 + j) * n + i];
          gc = a.g[(cos0 + k * 3 + j) * n + i];
        },
        gm[j], gvc[j]);
  // Through the contraction: mean_c = J-image of x, v_c = d^2 v.
  float gx[3], gv[3];
  for (int j = 0; j < 3; ++j) gv[j] = gvc[j] * c.d[j] * c.d[j];
  if (!CONTRACT || c.inside) {
    for (int j = 0; j < 3; ++j) gx[j] = gm[j];
  } else {
    // Outside the threshold (u = 1/n, sigma = sum x):
    //   mean_c_i = (2u - u^2) x_i,  d_i = 2u - u^2 + 2 x_i sigma (u^4 - u^3),
    //   du/dx_j = -u^3 x_j where the norm is not clamped.
    const float u = c.inv_n, u2 = u * u, u3 = u2 * u, u4 = u2 * u2;
    const float du = c.sq >= NORM_FLOOR ? -u3 : 0.f;  // du/dx_j = du * x_j
    const bool live = c.sq > NORM_FLOOR;              // the sum term of d
    const float sigma = live ? c.sum : 0.f;
    float xg = 0.f, q_sum = 0.f, qx = 0.f, q[3];
    for (int j = 0; j < 3; ++j) {
      xg += c.x[j] * gm[j];
      q[j] = 2.f * gvc[j] * c.vin[j] * c.d[j];  // d(v_c)/d(d_j) weighted by the cotangent
      q_sum += q[j];
      qx += q[j] * c.x[j];
    }
    for (int j = 0; j < 3; ++j) {
      float t = (2.f * u - u2) * gm[j] + (2.f - 2.f * u) * du * c.x[j] * (xg + q_sum);
      if (live)
        t += 2.f * (u4 - u3) * (q[j] * sigma + qx) + 2.f * sigma * (4.f * u3 - 3.f * u2) * du * c.x[j] * qx;
      gx[j] = t;
    }
  }
  const float m = MASK ? bkgd_mask(a, i) : 1.f;
  for (int j = 0; j < 3; ++j) {
    a.dx[j * n + i] = MASK ? m * gx[j] : gx[j];
    a.dv[j * n + i] = MASK ? m * gv[j] : gv[j];
  }
}

template <bool BWD, int MODE, bool REC, bool SAFE, bool CONTRACT, bool MASK>
int run(const Args& a, cudaStream_t s) {
  // Threads: one a sample, in VIEW one an output feature (a ray and
  // coordinate in the backward), indexed in 32 bits there.
  const long long work = MODE != VIEW ? a.n : a.n * (BWD ? 3 : 3 + 6 * a.n_deg);
  if (MODE == VIEW && work > 0x7fffffffLL) return -1;
  const long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return -1;
  if (blocks == 0) return 0;
  if (BWD)
    encode_bwd<MODE, REC, SAFE, CONTRACT, MASK><<<(unsigned)blocks, THREADS, 0, s>>>(a);
  else
    encode_fwd<MODE, REC, SAFE, CONTRACT, MASK><<<(unsigned)blocks, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// Runtime flags to template arguments; the mask and the contraction exist
// only in BACKGROUND, the range reduction only in the direct form.
template <bool BWD, int MODE, bool REC, bool SAFE, bool CONTRACT>
int with_mask(const Args& a, cudaStream_t s) {
  if constexpr (MODE == BACKGROUND) {
    if (a.hit != nullptr) return run<BWD, MODE, REC, SAFE, CONTRACT, true>(a, s);
  }
  return run<BWD, MODE, REC, SAFE, CONTRACT, false>(a, s);
}

template <bool BWD, int MODE, bool REC, bool SAFE>
int with_contract(const Args& a, cudaStream_t s, bool contract) {
  if constexpr (MODE == BACKGROUND) {
    if (contract) return with_mask<BWD, MODE, REC, SAFE, true>(a, s);
  }
  return with_mask<BWD, MODE, REC, SAFE, false>(a, s);
}

template <bool BWD, int MODE>
int with_form(const Args& a, cudaStream_t s, bool rec, bool safe, bool contract) {
  if constexpr (MODE == VIEW) {
    return with_contract<BWD, MODE, false, false>(a, s, false);
  } else {
    if (rec) return with_contract<BWD, MODE, true, false>(a, s, contract);
    if (safe) return with_contract<BWD, MODE, false, true>(a, s, contract);
    return with_contract<BWD, MODE, false, false>(a, s, contract);
  }
}

template <bool BWD>
int dispatch(int mode, const Args& a, bool rec, bool safe, bool contract, void* stream) {
  if (a.n_deg < 0 || a.n_deg > MAX_DEGS || a.n < 0) return -1;
  if (mode == BACKGROUND && a.hit != nullptr && (a.s_per_ray <= 0 || a.n_obj <= 0)) return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case WINDOWED: return with_form<BWD, WINDOWED>(a, s, rec, safe, contract);
    case BACKGROUND: return with_form<BWD, BACKGROUND>(a, s, rec, safe, contract);
    case VIEW: return with_form<BWD, VIEW>(a, s, rec, safe, contract);
  }
  return -2;
}

}  // namespace enc
}  // namespace durf

// mode: 0 windowed, 1 background, 2 view. x, v: [3, n] planes (VIEW: x is
// [n, 3] rows, v null); hit: [n / s_per_ray, n_obj] or null; alpha_p: a
// device float or null (then alpha). Returns the launch's cudaError_t, -1
// for arguments the kernel does not take, -2 for an unknown mode.
extern "C" int durf_encode_fwd(int mode, int rec, int safe, int contract, const float* x,
                               const float* v, const float* hit, int n_obj, int s_per_ray,
                               long long n, int min_deg, int max_deg, float alpha,
                               const float* alpha_p, float threshold, float* out, void* stream) {
  const durf::enc::Args a{x, v, hit, alpha_p, nullptr, out, nullptr, nullptr, n, n_obj, s_per_ray,
                          min_deg, max_deg - min_deg, alpha, threshold};
  return durf::enc::dispatch<false>(mode, a, rec, safe, contract, stream);
}

// The backward of durf_encode_fwd on the same inputs: g is laid out as its
// output; writes dx (as x) and, outside VIEW, dv (as v).
extern "C" int durf_encode_bwd(int mode, int rec, int safe, int contract, const float* x,
                               const float* v, const float* hit, int n_obj, int s_per_ray,
                               long long n, int min_deg, int max_deg, float alpha,
                               const float* alpha_p, float threshold, const float* g, float* dx,
                               float* dv, void* stream) {
  const durf::enc::Args a{x, v, hit, alpha_p, g, nullptr, dx, dv, n, n_obj, s_per_ray,
                          min_deg, max_deg - min_deg, alpha, threshold};
  return durf::enc::dispatch<true>(mode, a, rec, safe, contract, stream);
}
