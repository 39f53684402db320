// K4: the objects-in-grid MLP backward for Hopper (sm_90a).
//
// Replaces durf_tpu/ops/pallas/obj_mlp.py `fused_obj_mlp`'s backward
// (_obj_bwd, the pallas_call at obj_mlp.py:299): the vjp of K3
// (obj_mlp.cu), sum_o hit_o * MLP_o(x). For each object o the output
// cotangents are scaled by hit_o per ray; dx is summed over the objects,
// d cond_lin is returned per object and ray, the weight gradients are
// stacked per object, and the 0/1 hit mask gets no gradient.
//
// Bound on the H100: operations. Twice the forward's 0.33 MFLOP per sample
// per object at the flagship width (8x128, F_in 63): ~0.69 TFLOP for two
// objects at N = 4096 x 128 with every pair hit, i.e. 0.70 ms at the bf16
// peak; the pairs no ray hits are skipped, so the work is that of the pairs
// that run. The split design below moves ~10.8 GB a launch at that shape
// (the saved activations read twice, G written and read back), ~3.2 ms at
// full bandwidth: its own floor.
//
// What the TPU design relied on that Hopper lacks, and what this design does:
//  * The sequential grid (tiles x objects) carried stacked fp32 weight
//    gradients in VMEM across all steps. Here the tile kernel writes each
//    object's per-layer bf16 cotangents to a device workspace and
//    wide_dw_kernel (mlp_wide.cuh) forms A_{l-1}^T . G_l per object as a
//    split-K wgmma product over sample slices into fp32 partials, summed in
//    a fixed order by reduce_kernel: bitwise reproducible.
//  * Recomputed activations fit in VMEM; on an SM they do not. K3 saves the
//    shared input tile once and each object's bf16 activations when called
//    from the autograd Function's forward; the tile kernel reads them back
//    by TMA for the relu masks.
//  * dx accumulated over the inner object axis of the grid: here one CTA
//    walks its tile's objects in order and sums each object's dx in
//    registers, then stores the tile's rows, which no other CTA touches.
//  * A TPU tile held whole rays, so d cond_lin was a sum inside the tile.
//    A 128-sample tile need not align with rays here; ray_sum_kernel sums
//    each object's head_0 cotangent rows per ray, for any samples-per-ray.
// Every launch runs only the (tile, object) pairs some ray of the tile
// hits, reading the predicate from `hit` itself (mlp_obj.cuh).

#include "mlp_obj.cuh"

namespace durf {

static int launch_obj_bwd(const float* g_rgb, const float* g_den, const float* hit, const bf16* w,
                          const bf16* act, const bf16* x_save, bf16* g, float* dx, float* dcond,
                          const long long* jobs, const long long* jobs_host, int n_jobs,
                          int n_tiles, int n_splits, long long chunk, float* part, float* dw,
                          long long per_obj, long long g_head0, const obj::ObjDesc& od,
                          const long long* specs, int n_specs, const long long* slices,
                          int n_slices, cudaStream_t stream) {
  if (n_slices != obj::bwd_slices(od, dx != nullptr)) return -1;
  wide::Plan plan;
  const void* bases[5] = {x_save, act, g, w, nullptr};
  int err = wide::make_plan(plan, specs, n_specs, slices, n_slices, bases);
  if (err != 0) return err;
  wide::DwPlan dwp;
  if ((err = wide::make_dw_plan(dwp, jobs_host, n_jobs, od.n, x_save, act, g, od.n_obj,
                                od.act_stride, od.g_stride)) != 0)
    return err;

  const size_t smem = obj::bwd_smem(od);
  auto tile = od.xc == 1 ? obj::obj_mlp_bwd_kernel<4, 1> : obj::obj_mlp_bwd_kernel<4, 2>;
  cudaError_t ce = cudaFuncSetAttribute(tile, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  tile<<<obj::grid_of(od), wide::THREADS_TILE, smem, stream>>>(g_rgb, g_den, hit, w, act, g, dx,
                                                                plan, od);
  if ((err = (int)cudaGetLastError()) != 0) return err;

  const long long total = od.n_obj * per_obj;
  const size_t dsmem = wide::dw_smem((size_t)((chunk + wide::DW_BK - 1) / wide::DW_BK));
  auto dwk = wide::wide_dw_kernel<4, true>;
  ce = cudaFuncSetAttribute(dwk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dsmem);
  if (ce != cudaSuccess) return (int)ce;
  dwk<<<(unsigned)((long long)n_tiles * od.n_obj * n_splits), wide::THREADS_DW, dsmem, stream>>>(
      jobs, n_jobs, n_tiles, od.n, chunk, part, total, dwp, hit, od.n_obj, od.n_rays, od.s_per_ray,
      per_obj);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  long long blocks = (total + THREADS - 1) / THREADS;
  reduce_kernel<4><<<(unsigned)(blocks < 4096 ? blocks : 4096), THREADS, 0, stream>>>(part, n_splits,
                                                                                     total, dw);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  ray_sum_kernel<4><<<dim3((unsigned)od.n_rays, (unsigned)od.n_obj), obj::WIDTH, 0, stream>>>(
      g, od.g_stride, g_head0, obj::WIDTH, od.s_per_ray, od.n_rays, dcond, hit);
  return (int)cudaGetLastError();
}

}  // namespace durf

// The K4 entry point (ops/kernels/obj_mlp.py:_k4_launch). g_off: g_layout's
// offsets within one object's cotangent workspace, whose per-object stride
// g_stride is padded to whole [n][128] planes; jobs: one object's dW jobs
// (dw_jobs); dx nullptr skips the x-parts.
extern "C" int durf_fused_obj_mlp_bwd(
    const float* g_rgb, const float* g_den, const float* hit, long long n_rays, const void* w,
    const void* act, const void* x_save, void* g, float* dx, float* dcond, const long long* jobs,
    const long long* jobs_host, int n_jobs, int n_tiles, int n_splits, long long chunk, float* part,
    float* dw, long long per_obj, long long n, int s_per_ray, int n_obj, int in_dim, int width,
    int depth, int skip, int wc, int depth_cond, int n_rgb, int n_den, const long long* w_off,
    const long long* g_off, int n_layers, long long w_stride, long long act_stride,
    long long g_stride, const long long* specs, int n_specs, const long long* slices,
    int n_slices, void* stream) {
  durf::obj::ObjDesc od;
  if (durf::obj::make_desc(od, in_dim, width, depth, skip, wc, depth_cond, n_rgb, n_den, w_off,
                           nullptr, n_layers, n, n_rays, s_per_ray, n_obj, w_stride, 0,
                           act_stride) != 0)
    return -1;
  // The 128-wide segments lie one [n][128] plane apart; density and rgb
  // rows share the last plane.
  const long long plane = (long long)width * n;
  for (int l = 0; l < n_layers; ++l) {
    const bool head = l >= depth + 2 && l < depth + 2 + depth_cond;
    const int p = l < depth ? l : l == depth + 1 ? depth : head ? l - 1 : -1;
    if (p >= 0 && g_off[l] != p * plane) return -1;
  }
  if (g_stride != od.g_planes * plane || g_off[depth] < (od.g_planes - 1) * plane) return -1;
  od.g_stride = g_stride;
  od.g_den = g_off[depth];
  od.g_rgb = g_off[depth + 2 + depth_cond];
  return durf::launch_obj_bwd(
      g_rgb, g_den, hit, static_cast<const durf::bf16*>(w), static_cast<const durf::bf16*>(act),
      static_cast<const durf::bf16*>(x_save), static_cast<durf::bf16*>(g), dx, dcond, jobs,
      jobs_host, n_jobs, n_tiles, n_splits, chunk, part, dw, per_obj, g_off[depth + 2], od, specs,
      n_specs, slices, n_slices, static_cast<cudaStream_t>(stream));
}
