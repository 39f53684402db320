// K1: the fused background NeRF-MLP forward for Hopper (sm_90a).
//
// Replaces durf_tpu/ops/pallas/fused_mlp.py `fused_nerf_mlp` (_fused_forward,
// the pallas_call at fused_mlp.py:389): the whole NerfMLP (8 trunk layers
// with the skip input re-read at layer 5, density head, bottleneck,
// view-conditioned head, rgb head) on a tile of samples, with activations
// never leaving the SM.
//
// Bound on the H100: operations when it renders. At the flagship width
// (8x256 trunk, F_in 60, head 128) a sample costs 1.18 MFLOP of bf16
// products against ~256 bytes of input and output, far above the card's
// ~295 FLOP/byte balance point. The design keeps every intermediate in
// shared memory, so device memory sees only x, the per-ray condition rows,
// the weights (L2-resident: 1.2 MB) and the [4, N] outputs. The per-ray
// condition product viewdirs_enc @ head_0_kernel[width:] is hoisted out (one
// row per ray, not per sample).
//
// Called from the autograd Function's forward (ops/kernels/fused_mlp.py), it
// also writes the input tile and every stored activation in bf16 to device
// memory (save_x / save_act), the residuals K2 (fused_mlp_bwd.cu) reads:
// 2432 columns a sample at the flagship width, so with `save` its bound is
// the bytes of that save. The wide build also writes the relu masks of the
// trunk and head layers as bits (save_mask: 272 bytes a sample), which K2's
// tile kernel reads in place of the activations.
//
// Two builds: at the flagship widths (256 / 128) wide_mlp_fwd_kernel of
// mlp_wide.cuh, wgmma products whose weight slices arrive by TMA through an
// mbarrier ring and whose saved activations leave by TMA stores that overlap
// the next layer; at 128 / 128 (the object MLPs on the per-object route;
// the width of waymo_fast.gin's 4x128 proposal MLP) the mask-free build of
// K3's kernel (mlp_obj.cuh, obj_mlp_fwd_kernel<1>): K3 for one object on
// every tile, reading no mask, with its residuals in the object kernels'
// layout, one [n][128] plane per segment, which K2's 128 / 128 build
// reads. Other widths return -2 (ops/kernels/hopper_mlp.py BUILDS).

#include "mlp_obj.cuh"

namespace durf {

// K1 at 256 / 128 (mlp_wide.cuh): the tensor maps and the slice schedule
// come from the Python side (specs, slices; ops/kernels/hopper_mlp.py).
static int launch_wide(const float* x, const float* cond, const bf16* w, const float* b, float* rgb,
                       float* den, bf16* save_x, bf16* save_act, uint32_t* save_mask,
                       const long long* mask_off, const bf16* wt, long long n, int s_per_ray,
                       const MlpDesc& d, const long long* specs, int n_specs,
                       const long long* slices, int n_slices, cudaStream_t stream) {
  wide::WideDesc wd;
  wide::fill_desc(wd, d, n, s_per_ray, mask_off);
  if (wt == nullptr || wd.xc > 2 || n >= wide::MAX_SAMPLES || n_slices != wide::fwd_slices(wd) ||
      (save_x != nullptr && (save_mask == nullptr || mask_off == nullptr)))
    return -1;
  wide::Plan plan;
  const void* bases[5] = {save_x, save_act, nullptr, nullptr, wt};
  int err = wide::make_plan(plan, specs, n_specs, slices, n_slices, bases);
  if (err != 0) return err;
  const size_t smem = wide::fwd_smem(wd);
  auto kern = wide::wide_mlp_fwd_kernel<1>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long grid = (n + wide::ROWS - 1) / wide::ROWS;
  kern<<<(unsigned)grid, wide::THREADS_TILE, smem, stream>>>(x, cond, w, b, rgb, den, save_mask,
                                                            save_x != nullptr, plan, wd);
  return (int)cudaGetLastError();
}

}  // namespace durf

using durf::MlpDesc;

extern "C" int durf_fused_nerf_mlp_fwd(const float* x, const float* cond, const void* w,
                                       const float* b, float* rgb, float* den, long long n,
                                       int s_per_ray, int in_dim, int width, int depth, int skip,
                                       int wc, int depth_cond, int n_rgb, int n_den,
                                       const long long* w_off, const long long* b_off,
                                       int n_layers, void* save_x, void* save_act,
                                       const long long* act_off, int n_act, void* save_mask,
                                       const long long* mask_off, const void* wt,
                                       const long long* specs, int n_specs,
                                       const long long* slices, int n_slices, void* stream) {
  MlpDesc d;
  if (durf::make_fwd_desc(d, in_dim, width, depth, skip, wc, depth_cond, n_rgb, n_den, w_off, b_off,
                          n_layers, save_act != nullptr, act_off, n_act) != 0)
    return -1;
  auto wb = static_cast<const durf::bf16*>(w);
  auto sx = static_cast<durf::bf16*>(save_x);
  auto sa = static_cast<durf::bf16*>(save_act);
  auto s = static_cast<cudaStream_t>(stream);
  if (width == 256 && wc == 128)
    return durf::launch_wide(x, cond, wb, b, rgb, den, sx, sa, static_cast<uint32_t*>(save_mask),
                             mask_off, static_cast<const durf::bf16*>(wt), n, s_per_ray, d, specs,
                             n_specs, slices, n_slices, s);
  if (width == 128 && wc == 128) {  // one object: K3's maps and schedule (hopper_mlp.obj_fwd_plan)
    durf::obj::ObjDesc od;
    if (durf::obj::make_desc(od, in_dim, width, depth, skip, wc, depth_cond, n_rgb, n_den, w_off,
                             b_off, n_layers, n, n / s_per_ray, s_per_ray, 1, 0, 0, 0) != 0 ||
        (sa != nullptr && !durf::obj::act_planes(od, act_off, n_act)))
      return -1;
    return durf::obj::launch_fwd<1>(x, nullptr, cond, wb, b, rgb, den, sx, sa, od, specs, n_specs,
                                    slices, n_slices, s);
  }
  return -2;
}
