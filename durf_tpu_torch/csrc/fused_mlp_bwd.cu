// K2: the fused background NeRF-MLP backward for Hopper (sm_90a).
//
// Replaces durf_tpu/ops/pallas/fused_mlp.py `fused_nerf_mlp`'s backward
// (_fused_bwd -> _fused_bwd_impl, the pallas_call at fused_mlp.py:562): the
// vjp of K1 (fused_mlp.cu) giving dx, the per-ray d cond_lin (head_0's
// cotangent summed over the ray's samples; the view condition enters K1 per
// ray) and fp32 gradients of every weight and bias. head_0's condition rows
// get theirs from autograd through the per-ray product outside the kernel.
//
// Bound on the H100: operations for its products (the dX and dW products,
// twice the forward's 1.18 MFLOP per sample at the flagship width, ~1.24
// TFLOP at N = 4096 x 128, 1.25 ms at the bf16 peak), but the split design
// below moves ~10 GB a launch at that shape (the saved activations read for
// the masks and the dW products, each layer's cotangent written and read
// back), ~3 ms at full bandwidth.
//
// What the TPU design relied on that Hopper lacks, and what this design does:
//  * A sequential grid carried the weight-gradient sums: the TPU kernel
//    accumulates fp32 dW in VMEM-resident output blocks across grid steps.
//    CUDA blocks run in parallel, so the tile kernel writes each layer's
//    bf16 cotangent G_l to a device workspace, and a dW kernel forms
//    A_{l-1}^T . G_l as a split-K product over sample slices into fp32
//    partials that reduce_kernel sums in a fixed order (deterministic).
//  * The recomputed activations and vjp residuals lived in ~18 MB of VMEM;
//    an SM has 227 KB and one 64-sample tile's activations alone are
//    311 KB. K1 writes them (bf16) to device memory when called from the
//    autograd Function's forward, and this kernel reads them back for the
//    relu masks and the dW products instead of recomputing.
//  * A tile held whole rays: d cond_lin is a per-ray sum, taken here by
//    ray_sum_kernel over the head_0 cotangent rows for any samples-per-ray.
// Two builds, both wgmma + TMA, both with no transposed weight pack (B is
// the forward pack, the K-major operand of G_l W_l^T): at the flagship
// widths (256 / 128) the tile kernel and dW products of mlp_wide.cuh; at
// 128 / 128 (the object MLPs on the per-object route; the width of the
// 4x128 proposal MLP) the mask-free build of K4's launches (mlp_obj.cuh,
// TAG 2): its tile kernel for one object on every tile, wide_dw_kernel
// without the object axis, the fixed-order reduction and the per-ray sums,
// on the residuals K1's 128 / 128 build saved. No other widths are built
// (fused_mlp.py BWD_WIDTHS).

#include "mlp_obj.cuh"

namespace durf {

// K2: at 256 / 128 the wide tile kernel, the dW products, their reduction
// and the per-ray sums; at 128 / 128 one object of K4's launches
// (obj::launch_narrow_bwd).
template <>
int bwd_launch<2>(const BwdArgs& a, const MlpDesc& d, const BwdDesc& e, const GateArgs& ga,
                  const WideArgs& wa, cudaStream_t stream) {
  if (ga.gate != nullptr) return -1;
  if (d.width == 128 && d.wc == 128) return obj::launch_narrow_bwd<2>(a, d, e, ga, wa, stream);
  if (d.width != 256 || d.wc != 128) return -2;
  wide::WideDesc wd;
  wide::fill_desc(wd, d, a.n, a.s_per_ray);
  wd.act_last = d.act_off[d.depth + d.depth_cond];
  wd.g_rgb = e.g_off[d.depth + 2 + d.depth_cond];
  wd.g_den = e.g_off[d.depth];
  if (a.jobs_host == nullptr || wd.xc > 2 || a.n >= wide::MAX_SAMPLES ||
      wa.n_slices != wide::bwd_slices(wd, a.dx != nullptr))
    return -1;
  wide::Plan plan;
  const void* bases[5] = {a.x_save, a.act, a.g, a.w, nullptr};
  int err = wide::make_plan(plan, wa.specs, wa.n_specs, wa.slices, wa.n_slices, bases);
  if (err != 0) return err;
  wide::DwPlan dwp;
  if ((err = wide::make_dw_plan(dwp, a.jobs_host, a.n_jobs, a.n, a.x_save, a.act, a.g)) != 0)
    return err;

  const size_t smem = wide::bwd_smem();
  auto tile = wide::wide_mlp_bwd_kernel<2>;
  cudaError_t ce = cudaFuncSetAttribute(tile, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  const long long grid = (a.n + wide::ROWS - 1) / wide::ROWS;
  tile<<<(unsigned)grid, wide::THREADS_TILE, smem, stream>>>(a.g_rgb, a.g_den, a.w, a.act, a.g,
                                                             a.dx, plan, wd);
  if ((err = (int)cudaGetLastError()) != 0) return err;

  const size_t dsmem = wide::dw_smem();
  auto dw = wide::wide_dw_kernel<2>;
  ce = cudaFuncSetAttribute(dw, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dsmem);
  if (ce != cudaSuccess) return (int)ce;
  dw<<<(unsigned)((long long)a.n_tiles * a.n_splits), wide::THREADS_DW, dsmem, stream>>>(
      a.jobs, a.n_jobs, a.n_tiles, a.n, a.chunk, a.part, a.total, dwp, nullptr, 1, 0, 1, 0);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  if ((err = launch_reduce<2>(a, stream)) != 0) return err;
  return launch_ray_sum<2>(a, d, e, stream);
}

}  // namespace durf

DURF_DEFINE_BWD_ENTRY(durf_fused_nerf_mlp_bwd, 2)
