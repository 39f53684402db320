// K3: the objects-in-grid MLP forward for Hopper (sm_90a).
//
// Replaces durf_tpu/ops/pallas/obj_mlp.py `fused_obj_mlp` (_obj_forward, the
// pallas_call at obj_mlp.py:193): every object MLP over a tile of samples,
// returning sum_o hit_o * MLP_o(x) feature-major. Where the TPU walks the
// object axis as an inner grid dimension and accumulates into its output
// block, a CTA here loads the shared feature tile once, loops over the
// objects itself and keeps the gated sums in registers, so there is no
// cross-CTA reduction.
//
// Bound on the H100: operations. At the flagship width (8x128 object MLPs,
// F_in 63, head 128) a sample costs 0.33 MFLOP per object of bf16 products
// (head_0's condition rows are hoisted out as per-ray rows `cond_lin`,
// rounded to bf16 as the JAX package does) against ~270 bytes of input and
// output. The per-layer work is the same tensor-core tile pipeline as K1
// (mlp_tile.cuh); only the input features are shared across objects.
//
// Called from the autograd Function's forward (ops/kernels/obj_mlp.py), it
// also writes the shared input tile once and each object's stored
// activations in bf16 to device memory, the residuals K4 (obj_mlp_bwd.cu)
// reads.
//
// Two designs: at the object MLPs' width (128 / 128, ModelConfig.box_mlp)
// obj_mlp_fwd_kernel of mlp_obj.cuh, wgmma products whose weight slices
// arrive by TMA through an mbarrier ring, running only the (tile, object)
// pairs that some ray of the tile hits; at other widths (a BoxMLP widened
// by a gin file) the mma.sync tile code of mlp_tile.cuh, every pair.

#include "mlp_obj.cuh"

namespace durf {

template <int NTW, int NTC>
__global__ void __launch_bounds__(THREADS)
    fused_obj_mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ hit,
                             const float* __restrict__ cond_lin, const bf16* __restrict__ w,
                             const float* __restrict__ b, float* __restrict__ rgb_out,
                             float* __restrict__ den_out, bf16* __restrict__ save_x,
                             bf16* __restrict__ save_act, long long n, long long n_rays,
                             int s_per_ray, int n_obj, MlpDesc d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hmax = d.width > d.wc ? d.width : d.wc;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* hs = xs + TILE_M * ld_of(d.in_pad);
  bf16* ws = hs + TILE_M * ld_of(hmax);
  const long long tile0 = (long long)blockIdx.x * TILE_M;
  const long long sample = tile0 + (threadIdx.x >> 1);
  const long long ray = sample < n ? sample / s_per_ray : 0;

  load_x_tile(xs, x, d, tile0, n);
  if (save_x != nullptr) store_tile(xs, ld_of(d.in_pad), d.in_pad, save_x, tile0, n);
  float rgb_acc[4] = {0.f, 0.f, 0.f, 0.f}, den_acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int o = 0; o < n_obj; ++o) {
    float rgb[4], den[4];
    run_mlp<NTW, NTC>(d, w + o * d.w_obj_stride, b + o * d.b_obj_stride,
                      cond_lin + (long long)o * n_rays * d.wc, xs, hs, ws, tile0, n, s_per_ray,
                      rgb, den, save_act == nullptr ? nullptr : save_act + o * d.act_obj_stride);
    const float g = hit[(long long)o * n_rays + ray];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      rgb_acc[c] += g * rgb[c];
      den_acc[c] += g * den[c];
    }
  }
  if ((threadIdx.x & 1) == 0 && sample < n) {
    for (int c = 0; c < d.n_rgb; ++c) rgb_out[c * n + sample] = rgb_acc[c];
    for (int c = 0; c < d.n_den; ++c) den_out[c * n + sample] = den_acc[c];
  }
}

template <int NTW, int NTC>
static int launch(const float* x, const float* hit, const float* cond_lin, const bf16* w,
                  const float* b, float* rgb, float* den, bf16* save_x, bf16* save_act,
                  long long n, long long n_rays, int s_per_ray, int n_obj, const MlpDesc& d,
                  cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  auto kern = fused_obj_mlp_fwd_kernel<NTW, NTC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (n + TILE_M - 1) / TILE_M;
  kern<<<(unsigned)grid, THREADS, smem, stream>>>(x, hit, cond_lin, w, b, rgb, den, save_x,
                                                  save_act, n, n_rays, s_per_ray, n_obj, d);
  return (int)cudaGetLastError();
}

}  // namespace durf

using durf::MlpDesc;

extern "C" int durf_fused_obj_mlp_fwd(const float* x, const float* hit, const float* cond_lin,
                                      const void* w, const float* b, float* rgb, float* den,
                                      long long n, long long n_rays, int s_per_ray, int n_obj,
                                      int in_dim, int width, int depth, int skip, int wc,
                                      int depth_cond, int n_rgb, int n_den,
                                      const long long* w_off, const long long* b_off,
                                      int n_layers, long long w_obj_stride,
                                      long long b_obj_stride, void* save_x, void* save_act,
                                      const long long* act_off, int n_act,
                                      long long act_obj_stride, const long long* specs,
                                      int n_specs, const long long* slices, int n_slices,
                                      void* stream) {
  if (n_layers > durf::MAX_LAYERS || n_layers != depth + depth_cond + 3) return -1;
  MlpDesc d = {};
  d.in_dim = in_dim;
  d.in_pad = (in_dim + durf::BK - 1) / durf::BK * durf::BK;
  d.width = width;
  d.depth = depth;
  d.skip = skip;
  d.wc = wc;
  d.depth_cond = depth_cond;
  d.n_rgb = n_rgb;
  d.n_den = n_den;
  d.w_obj_stride = w_obj_stride;
  d.b_obj_stride = b_obj_stride;
  for (int l = 0; l < n_layers; ++l) {
    d.w_off[l] = w_off[l];
    d.b_off[l] = b_off[l];
  }
  if (save_act != nullptr && n_act != depth + 1 + depth_cond) return -1;
  for (int a = 0; save_act != nullptr && a < n_act; ++a) d.act_off[a] = act_off[a];
  d.act_obj_stride = act_obj_stride;
  auto wb = static_cast<const durf::bf16*>(w);
  auto sx = static_cast<durf::bf16*>(save_x);
  auto sa = static_cast<durf::bf16*>(save_act);
  auto s = static_cast<cudaStream_t>(stream);
  if (width == 128 && wc == 128) {  // mlp_obj.cuh: maps and schedule from the Python side
    durf::obj::ObjDesc od;
    if (durf::obj::make_desc(od, in_dim, width, depth, skip, wc, depth_cond, n_rgb, n_den, w_off,
                             b_off, n_layers, n, n_rays, s_per_ray, n_obj, w_obj_stride,
                             b_obj_stride, act_obj_stride) != 0 ||
        (sa != nullptr && !durf::obj::act_planes(od, act_off, n_act)))
      return -1;
    return durf::obj::launch_fwd<3>(x, hit, cond_lin, wb, b, rgb, den, sx, sa, od, specs, n_specs,
                                    slices, n_slices, s);
  }
  if (width == 256 && wc == 128)
    return durf::launch<8, 4>(x, hit, cond_lin, wb, b, rgb, den, sx, sa, n, n_rays, s_per_ray,
                                     n_obj, d, s);
  if (width == 128 && wc == 256)
    return durf::launch<4, 8>(x, hit, cond_lin, wb, b, rgb, den, sx, sa, n, n_rays, s_per_ray,
                                     n_obj, d, s);
  if (width == 256 && wc == 256)
    return durf::launch<8, 8>(x, hit, cond_lin, wb, b, rgb, den, sx, sa, n, n_rays, s_per_ray,
                                     n_obj, d, s);
  return -2;
}
