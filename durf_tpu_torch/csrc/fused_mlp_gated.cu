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
// Two builds. At 128 / 128, the object MLPs' width and the only one K6 is
// built for, the mask-free build of K3's kernel (mlp_obj.cuh,
// obj_mlp_fwd_kernel<5>): K1's 128 / 128 build, a persistent wgmma + TMA
// kernel on K3's plan for one object, whose prologue blends the input tile
// from the bf16 rows (plain coalesced loads: a 126-byte row stride is not a
// TMA stride). At other widths the mma.sync tile code of mlp_tile.cuh (the
// whole MLP on a 128-sample tile in shared memory, the per-ray condition
// product hoisted out), whose prologue load_x_tile_gated is the same blend.
//
// Called from the autograd Function's forward (ops/kernels/fused_mlp.py) it
// also writes the blended tile and every stored activation in bf16 to device
// memory, the residuals K6 (fused_mlp_gated_bwd.cu) reads.

#include "mlp_obj.cuh"

namespace durf {

// xs[r][f] = bf16(g * x[s][f] + (1 - g) * fill[f]) for the tile's samples s
// = tile0 + r, g = gate[s / s_per_ray]; zero past in_dim and past n. A warp
// takes a row at a time, its lanes neighbouring features (coalesced reads
// of the row, one gate load per row).
__device__ void load_x_tile_gated(bf16* xs, const bf16* x, const float* gate, const bf16* fill,
                                  const MlpDesc& d, long long tile0, long long n, int s_per_ray) {
  const int ldx = ld_of(d.in_pad);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < TILE_M; r += THREADS / 32) {
    const long long s = tile0 + r;
    const bool valid = s < n;
    const float g = valid ? gate[s / s_per_ray] : 0.f;
    const bf16* xr = x + s * d.in_dim;
    for (int f = lane; f < d.in_pad; f += 32) {
      float v = 0.f;
      if (valid && f < d.in_dim)
        v = __fadd_rn(__fmul_rn(g, __bfloat162float(xr[f])),
                      __fmul_rn(1.f - g, __bfloat162float(fill[f])));
      xs[r * ldx + f] = __float2bfloat16_rn(v);
    }
  }
  __syncthreads();
}

template <int NTW, int NTC>
__global__ void __launch_bounds__(THREADS)
    fused_nerf_mlp_gated_fwd_kernel(const bf16* __restrict__ x, const float* __restrict__ gate,
                                    const bf16* __restrict__ fill, const float* __restrict__ cond,
                                    const bf16* __restrict__ w, const float* __restrict__ b,
                                    float* __restrict__ rgb_out, float* __restrict__ den_out,
                                    bf16* __restrict__ save_x, bf16* __restrict__ save_act,
                                    long long n, int s_per_ray, MlpDesc d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hmax = d.width > d.wc ? d.width : d.wc;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* hs = xs + TILE_M * ld_of(d.in_pad);
  bf16* ws = hs + TILE_M * ld_of(hmax);
  const long long tile0 = (long long)blockIdx.x * TILE_M;

  load_x_tile_gated(xs, x, gate, fill, d, tile0, n, s_per_ray);
  if (save_x != nullptr) store_tile(xs, ld_of(d.in_pad), d.in_pad, save_x, tile0, n);
  float rgb[4], den[4];
  run_mlp<NTW, NTC>(d, w, b, cond, xs, hs, ws, tile0, n, s_per_ray, rgb, den, save_act);

  const long long sample = tile0 + (threadIdx.x >> 1);
  if ((threadIdx.x & 1) == 0 && sample < n) {
    for (int c = 0; c < d.n_rgb; ++c) rgb_out[sample * d.n_rgb + c] = rgb[c];
    for (int c = 0; c < d.n_den; ++c) den_out[sample * d.n_den + c] = den[c];
  }
}

template <int NTW, int NTC>
static int launch(const bf16* x, const float* gate, const bf16* fill, const float* cond,
                  const bf16* w, const float* b, float* rgb, float* den, bf16* save_x,
                  bf16* save_act, long long n, int s_per_ray, const MlpDesc& d,
                  cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  auto kern = fused_nerf_mlp_gated_fwd_kernel<NTW, NTC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (n + TILE_M - 1) / TILE_M;
  kern<<<(unsigned)grid, THREADS, smem, stream>>>(x, gate, fill, cond, w, b, rgb, den, save_x,
                                                  save_act, n, s_per_ray, d);
  return (int)cudaGetLastError();
}

}  // namespace durf

using durf::MlpDesc;

// The plan (specs .. n_slices) is K3's for one object
// (hopper_mlp.obj_fwd_plan), read at 128 / 128 only.
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
  MlpDesc d;
  if (durf::make_fwd_desc(d, in_dim, width, depth, skip, wc, depth_cond, n_rgb, n_den, w_off, b_off,
                          n_layers, save_act != nullptr, act_off, n_act) != 0)
    return -1;
  auto xb = static_cast<const durf::bf16*>(x);
  auto fb = static_cast<const durf::bf16*>(fill);
  auto wb = static_cast<const durf::bf16*>(w);
  auto sx = static_cast<durf::bf16*>(save_x);
  auto sa = static_cast<durf::bf16*>(save_act);
  auto s = static_cast<cudaStream_t>(stream);
  if (width == 128 && wc == 128) {  // one object of K3's kernel, reading no mask
    durf::obj::ObjDesc od;
    if (durf::obj::make_desc(od, in_dim, width, depth, skip, wc, depth_cond, n_rgb, n_den, w_off,
                             b_off, n_layers, n, n / s_per_ray, s_per_ray, 1, 0, 0, 0) != 0 ||
        (sa != nullptr && !durf::obj::act_planes(od, act_off, n_act)))
      return -1;
    const durf::GateArgs ga{xb, gate, fb, nullptr, nullptr, nullptr};
    return durf::obj::launch_fwd<5>(nullptr, nullptr, cond, wb, b, rgb, den, sx, sa, od, specs,
                                    n_specs, slices, n_slices, s, ga);
  }
  if (width == 128 && wc == 256)
    return durf::launch<4, 8>(xb, gate, fb, cond, wb, b, rgb, den, sx, sa, n, s_per_ray, d, s);
  if (width == 256 && wc == 128)
    return durf::launch<8, 4>(xb, gate, fb, cond, wb, b, rgb, den, sx, sa, n, s_per_ray, d, s);
  if (width == 256 && wc == 256)
    return durf::launch<8, 8>(xb, gate, fb, cond, wb, b, rgb, den, sx, sa, n, s_per_ray, d, s);
  return -2;
}
