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
// output.
//
// Called from the autograd Function's forward (ops/kernels/obj_mlp.py), it
// also writes the shared input tile once and each object's stored
// activations in bf16 to device memory, the residuals K4 (obj_mlp_bwd.cu)
// reads.
//
// Built at the object MLPs' width (128 / 128, ModelConfig.box_mlp) only:
// obj_mlp_fwd_kernel of mlp_obj.cuh, wgmma products whose weight slices
// arrive by TMA through an mbarrier ring, running only the (tile, object)
// pairs that some ray of the tile hits. Other widths return -2
// (ops/kernels/hopper_mlp.py BUILDS).

#include "mlp_obj.cuh"

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
  if (width != 128 || wc != 128) return -2;
  auto sa = static_cast<durf::bf16*>(save_act);
  durf::obj::ObjDesc od;
  if (durf::obj::make_desc(od, in_dim, width, depth, skip, wc, depth_cond, n_rgb, n_den, w_off,
                           b_off, n_layers, n, n_rays, s_per_ray, n_obj, w_obj_stride, b_obj_stride,
                           act_obj_stride) != 0 ||
      (sa != nullptr && !durf::obj::act_planes(od, act_off, n_act)))
    return -1;
  return durf::obj::launch_fwd<3>(x, hit, cond_lin, static_cast<const durf::bf16*>(w), b, rgb, den,
                                  static_cast<durf::bf16*>(save_x), sa, od, specs, n_specs, slices,
                                  n_slices, static_cast<cudaStream_t>(stream));
}
