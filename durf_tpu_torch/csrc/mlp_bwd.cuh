// What the backward launches share (Hopper, sm_90a): the arguments of the
// K2 and K6 entry points (DURF_DEFINE_BWD_ENTRY) and of K4's, and the small
// kernels that follow every backward's tile kernel and dW products.
//
// The tile kernels and dW products are wgmma + TMA kernels: K2 at the
// flagship widths (256 / 128) those of mlp_wide.cuh, K2, K4 and K6 at the
// object width (128 / 128) those of mlp_obj.cuh with mlp_wide.cuh's
// wide_dw_kernel. Each backward then runs, on its stream:
//  * reduce_kernel: the dW products' per-slice fp32 partials summed in a
//    fixed order, so the gradients are deterministic;
//  * ray_sum_kernel: d cond_lin[ray] = the sum over the ray's samples of
//    head_0's cotangent (the view condition enters per ray);
//  * K6 only, feature_sum_kernel: d fill = the sum, in a fixed order, of
//    the per-tile partials the tile kernel's gate epilogue wrote.
//
// Rounding points follow the TPU kernel's backward (durf_tpu/ops/pallas/
// fused_mlp.py:58-77 with act_dtype=bf16): activations are stored in bf16,
// every cotangent is rounded to bf16 before a product, products accumulate
// in fp32, and the relu masks come from the stored activations.

#pragma once

#include "mlp_tile.cuh"

namespace durf {

// The cotangent workspace (bf16): G_l is [n][gw_l] at g_off[l], gw_l =
// width (trunk, bottleneck), wc (head), 8 (density and rgb heads, zero past
// their channels); ops/kernels/fused_mlp.py:g_layout.
struct BwdDesc {
  long long g_off[MAX_LAYERS];
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// K5's and K6's gate: the MLP runs on xe = bf16(g * x + (1 - g) * fill), g
// the per-ray gate, x [n][in_dim] and fill [in_dim] the bf16 input rows. K6
// also writes the gate's vjp: dgate per sample, per-tile partial sums of
// dfill and their total. All null for K1-K4.
struct GateArgs {
  const bf16* x;
  const float* gate;   // [n_rays]
  const bf16* fill;
  float* dgate;        // [n] per sample
  float* dfill_part;   // [in_dim][tiles] per-tile partial sums
  float* dfill;        // [in_dim]
};

// out[i] = sum over slices s of part[s][i], in slice order.
template <int TAG>
__global__ void reduce_kernel(const float* __restrict__ part, int n_splits, long long total,
                              float* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < n_splits; ++k) s += part[(long long)k * total + i];
    out[i] = s;
  }
}

// dcond[o][r][c] = sum over the ray's samples of G_head0[o][r * S + s][c]
// (fp32). One block per (ray, object), one thread per column. With `hit`
// ([n_obj][n_rays], K4), a ray that misses the object gets 0: K4 skips the
// pairs no ray of a tile hits, so its G rows may never have been written.
template <int TAG>
__global__ void ray_sum_kernel(const bf16* __restrict__ g, long long g_obj_stride,
                               long long g_off, int wc, int s_per_ray, long long n_rays,
                               float* __restrict__ dcond, const float* __restrict__ hit = nullptr) {
  const long long r = blockIdx.x;
  const int o = blockIdx.y, c = threadIdx.x;
  const bf16* src = g + o * g_obj_stride + g_off + r * s_per_ray * wc + c;
  float s = 0.f;
  if (hit == nullptr || hit[o * n_rays + r] != 0.f)
    for (int i = 0; i < s_per_ray; ++i) s += __bfloat162float(src[(long long)i * wc]);
  dcond[((long long)o * n_rays + r) * wc + c] = s;
}

// out[f] = sum over tiles of part[f][tile]: one block per feature, each
// thread a fixed strided subset, then a fixed shared-memory tree.
template <int TAG>
__global__ void __launch_bounds__(THREADS)
    feature_sum_kernel(const float* __restrict__ part, int tiles, float* __restrict__ out) {
  __shared__ float red[THREADS];
  const float* row = part + (long long)blockIdx.x * tiles;
  float s = 0.f;
  for (int t = threadIdx.x; t < tiles; t += THREADS) s += row[t];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = THREADS / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = red[0];
}

// Arguments shared by the K2, K4 and K6 entry points: the launches of one
// MLP backward on `stream`.
struct BwdArgs {
  const float* g_rgb;
  const float* g_den;
  long long n_rays;
  const bf16* w;     // forward pack (the K-major B of G_l W_l^T; the heads' weights)
  const bf16* act;   // saved activations
  const bf16* x_save;  // saved input rows
  bf16* g;           // cotangent workspace
  float* dx;         // [in_dim][n], every row stored, or nullptr
  float* dcond;      // [n_rays][wc]
  const long long* jobs;       // the dW job table on the device
  const long long* jobs_host;  // the same in host memory (the dW maps are built from it)
  int n_jobs, n_tiles, n_splits;
  long long chunk;
  float* part;       // [n_splits][total]
  float* dw;         // [total]
  long long total;
  long long n;
  int s_per_ray;
};

template <int TAG>
int launch_reduce(const BwdArgs& a, cudaStream_t stream) {
  long long blocks = (a.total + THREADS - 1) / THREADS;
  if (blocks > 4096) blocks = 4096;
  reduce_kernel<TAG><<<(unsigned)blocks, THREADS, 0, stream>>>(a.part, a.n_splits, a.total, a.dw);
  return (int)cudaGetLastError();
}

template <int TAG>
int launch_ray_sum(const BwdArgs& a, const MlpDesc& d, const BwdDesc& e, cudaStream_t stream) {
  ray_sum_kernel<TAG><<<(unsigned)a.n_rays, d.wc, 0, stream>>>(
      a.g, 0, e.g_off[d.depth + 2], d.wc, a.s_per_ray, a.n_rays, a.dcond);
  return (int)cudaGetLastError();
}

// The producer's schedule (specs, slices) of the wgmma + TMA tile kernels,
// as the Python side built it.
struct WideArgs {
  const long long* specs;
  int n_specs;
  const long long* slices;
  int n_slices;
};

// The launches of one backward: each .cu that expands DURF_DEFINE_BWD_ENTRY
// defines it for its TAG (fused_mlp_bwd.cu: K2, 2; fused_mlp_gated_bwd.cu:
// K6, 6). -2 for widths it is not built for.
template <int TAG>
int bwd_launch(const BwdArgs&, const MlpDesc&, const BwdDesc&, const GateArgs&, const WideArgs&,
               cudaStream_t);

// Descriptors from the flat arrays the Python wrappers pass.
inline int make_bwd_descs(MlpDesc& d, BwdDesc& e, int in_dim, int width, int depth, int skip,
                          int wc, int depth_cond, int n_rgb, int n_den, const long long* w_off,
                          const long long* act_off, const long long* g_off, int n_layers) {
  if (n_layers > MAX_LAYERS || n_layers != depth + depth_cond + 3) return -1;
  d = MlpDesc{};
  e = BwdDesc{};
  d.in_dim = in_dim;
  d.in_pad = (in_dim + BK - 1) / BK * BK;
  d.width = width;
  d.depth = depth;
  d.skip = skip;
  d.wc = wc;
  d.depth_cond = depth_cond;
  d.n_rgb = n_rgb;
  d.n_den = n_den;
  for (int l = 0; l < n_layers; ++l) {
    d.w_off[l] = w_off[l];
    e.g_off[l] = g_off[l];
  }
  for (int a = 0; a < depth + 1 + depth_cond; ++a) d.act_off[a] = act_off[a];
  return 0;
}

}  // namespace durf

// The C entry point NAME of K2 (TAG 2) and K6 (TAG 6); each .cu expands it
// once. The gate pointers (gx .. dfill) are null except for K6.
#define DURF_DEFINE_BWD_ENTRY(NAME, TAG)                                                         \
  extern "C" int NAME(                                                                           \
      const float* g_rgb, const float* g_den, long long n_rays, const void* w, const void* act,  \
      const void* x_save, void* g, float* dx, float* dcond, const long long* jobs,               \
      const long long* jobs_host, int n_jobs, int n_tiles, int n_splits, long long chunk,        \
      float* part, float* dw, long long total, long long n, int s_per_ray, int in_dim,           \
      int width, int depth, int skip, int wc, int depth_cond, int n_rgb, int n_den,              \
      const long long* w_off, const long long* act_off, const long long* g_off, int n_layers,    \
      const void* gx, const float* gate, const void* gfill, float* dgate, float* dfill_part,     \
      float* dfill, const long long* specs, int n_specs, const long long* slices, int n_slices,  \
      void* stream) {                                                                            \
    durf::MlpDesc d;                                                                             \
    durf::BwdDesc e;                                                                             \
    int err = durf::make_bwd_descs(d, e, in_dim, width, depth, skip, wc, depth_cond, n_rgb,      \
                                   n_den, w_off, act_off, g_off, n_layers);                      \
    if (err != 0) return err;                                                                    \
    durf::BwdArgs a{g_rgb,                                                                       \
                    g_den,                                                                       \
                    n_rays,                                                                      \
                    static_cast<const durf::bf16*>(w),                                           \
                    static_cast<const durf::bf16*>(act),                                         \
                    static_cast<const durf::bf16*>(x_save),                                      \
                    static_cast<durf::bf16*>(g),                                                 \
                    dx,                                                                          \
                    dcond,                                                                       \
                    jobs,                                                                        \
                    jobs_host,                                                                   \
                    n_jobs,                                                                      \
                    n_tiles,                                                                     \
                    n_splits,                                                                    \
                    chunk,                                                                       \
                    part,                                                                        \
                    dw,                                                                          \
                    total,                                                                       \
                    n,                                                                           \
                    s_per_ray};                                                                  \
    durf::GateArgs ga{static_cast<const durf::bf16*>(gx), gate,                                  \
                      static_cast<const durf::bf16*>(gfill), dgate, dfill_part, dfill};          \
    durf::WideArgs wa{specs, n_specs, slices, n_slices};                                         \
    return durf::bwd_launch<TAG>(a, d, e, ga, wa, static_cast<cudaStream_t>(stream));            \
  }
