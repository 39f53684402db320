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
                           act_stride) != 0 ||
      durf::obj::set_g_layout(od, g_off, g_stride) != 0)
    return -1;
  const durf::BwdArgs a{g_rgb, g_den, n_rays, static_cast<const durf::bf16*>(w),
                        static_cast<const durf::bf16*>(act), static_cast<const durf::bf16*>(x_save),
                        static_cast<durf::bf16*>(g), dx, dcond, jobs, jobs_host, n_jobs, n_tiles,
                        n_splits, chunk, part, dw, n_obj * per_obj, n, s_per_ray};
  return durf::obj::launch_bwd<4>(a, hit, od, durf::WideArgs{specs, n_specs, slices, n_slices},
                                  static_cast<cudaStream_t>(stream));
}
