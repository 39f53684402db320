// K5: the gated fused NeRF-MLP forward for Hopper (sm_90a).
//
// Replaces durf_tpu/ops/pallas/fused_mlp.py `fused_nerf_mlp_gated` (its
// forward _fused_forward with gate and fill, fused_mlp.py:316-335, the
// pallas_call at fused_mlp.py:389): K1's MLP on the input blended in the
// tile, xe = bf16(g * x + (1 - g) * fill), from row-major bf16 features x
// [n][in_dim] shared by every object, a per-ray gate g (fp32) and one bf16
// fill row. The scene graph gates each object MLP by its 0/1 ray-box hit
// mask and fills with the encoding of the zero sample; blending in the tile
// keeps the per-object [n][in_dim] blends out of device memory.
//
// Bound on the H100: operations, as K1. At the object width (8x128 trunk,
// F_in 63, head 128) a sample costs 0.33 MFLOP of bf16 products against
// ~150 bytes of input and output. The blend rounds exactly where the JAX
// kernel does: x and fill arrive in bf16, g * x + (1 - g) * fill is formed
// in fp32 (no fused multiply-add, as the plain version computes it) and
// rounded to bf16. Outputs are row-major rgb [n][n_rgb] and density
// [n][n_den], the layout of the JAX kernel's gated call. No tile is
// skipped: a row whose gate is 0 runs the MLP on the fill row.
//
// Built at 128 / 128 only, the object MLPs' width and K6's: the mask-free
// build of K3's kernel (mlp_obj.cuh, obj_mlp_fwd_kernel<5>), K1's 128 / 128
// build, a persistent wgmma + TMA kernel on K3's plan for one object, whose
// prologue blends the input tile from the bf16 rows (plain coalesced loads:
// a 126-byte row stride is not a TMA stride). Other widths return -2
// (ops/kernels/hopper_mlp.py BUILDS).
//
// Called from the autograd Function's forward (ops/kernels/fused_mlp.py) it
// also writes the blended tile and every stored activation in bf16 to device
// memory, the residuals K6 (fused_mlp_gated_bwd.cu) reads.

#include "mlp_obj.cuh"

// The plan (specs .. n_slices) is K3's for one object
// (hopper_mlp.obj_fwd_plan).
extern "C" int durf_fused_nerf_mlp_gated_fwd(const void* x, const float* gate, const void* fill,
                                             const float* cond, const void* w, const float* b,
                                             float* rgb, float* den, long long n, int s_per_ray,
                                             int in_dim, int width, int depth, int skip, int wc,
                                             int depth_cond, int n_rgb, int n_den,
                                             const long long* w_off, const long long* b_off,
                                             int n_layers, void* save_x, void* save_act,
                                             const long long* act_off, int n_act,
                                             const long long* specs, int n_specs,
                                             const long long* slices, int n_slices, void* stream) {
  if (width != 128 || wc != 128) return -2;
  auto sa = static_cast<durf::bf16*>(save_act);
  durf::obj::ObjDesc od;
  if (durf::obj::make_desc(od, in_dim, width, depth, skip, wc, depth_cond, n_rgb, n_den, w_off,
                           b_off, n_layers, n, n / s_per_ray, s_per_ray, 1, 0, 0, 0) != 0 ||
      (sa != nullptr && !durf::obj::act_planes(od, act_off, n_act)))
    return -1;
  const durf::GateArgs ga{static_cast<const durf::bf16*>(x), gate,
                          static_cast<const durf::bf16*>(fill), nullptr, nullptr, nullptr};
  return durf::obj::launch_fwd<5>(nullptr, nullptr, cond, static_cast<const durf::bf16*>(w), b, rgb,
                                  den, static_cast<durf::bf16*>(save_x), sa, od, specs, n_specs,
                                  slices, n_slices, static_cast<cudaStream_t>(stream), ga);
}
