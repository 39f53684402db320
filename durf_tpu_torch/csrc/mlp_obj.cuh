// K3 and K4 at the object MLPs' width (8x128 trunk, head 128, F_in <= 128)
// on Hopper's wgmma with operands staged by TMA (sm_90a), skipping every
// (tile, object) pair that no ray of the tile hits.
//
// Both tile kernels have K1's and K2's shape (mlp_wide.cuh): two consumer
// warpgroups own 64 rows each of a 128-sample tile, a producer warpgroup
// keeps TMA loads of weight slices in flight through a 4-stage mbarrier
// ring of 16 KB stages, and activations and cotangents sit in shared memory
// in the 128-byte swizzle that wgmma reads. What is new is the object axis:
//
//  * The pair predicate. A tile spans the rays tile0 / S .. (tile0 + 127) /
//    S, clipped to the batch; it runs object o iff hit[o][r] != 0 for some
//    such ray (tile_runs). All threads of a block evaluate it from `hit`
//    for every pair of the block's tiles at once, into shared memory, before
//    the warps split, so the producer and the consumers walk the same
//    sequence of pairs: the producer issues one object's slice schedule per
//    pair that runs, with the object as the plane of the weight map, and
//    the consumers take those slices.
//  * Persistent blocks. One block per SM walks the tiles blockIdx.x,
//    blockIdx.x + gridDim.x, ...: a tile that runs no object costs its
//    predicate and its zero outputs, not a block launch, and the producer
//    runs ahead into the next tile's weights while the consumers finish.
//  * Exactness. For a 0/1 mask a skipped pair contributes 0 * MLP_o(x) to
//    rgb and density and 0 * g to every cotangent (the TPU kernel computes
//    it and multiplies by zero: durf_tpu/ops/pallas/obj_mlp.py:179-187,
//    :264), so skipping it changes no output wherever MLP_o(x) is finite.
//    What a skipped pair would have written (its saved activations, its
//    cotangent rows) is never written, and every reader skips it too: K4's
//    dW products skip the 64-sample stages whose rays all miss the object
//    (wide_dw_kernel's DwSkip), its per-ray sums give 0 to a ray that
//    misses (ray_sum_kernel), and dx rows of a tile that runs no object are
//    written as zeros.
//  * The maps. At this width every activation and cotangent segment is
//    [N][128], so one 3-D map each covers all objects and layers (plane o *
//    P + segment), and the forward weight pack of all objects is one map
//    [objects][rows][128] (ops/kernels/hopper_mlp.py:obj_fwd_plan,
//    obj_bwd_plan): the plan does not grow with the object count.
//
//  * obj_mlp_fwd_kernel (K3): per tile the shared input tile is loaded once
//    (and only if some object runs), then each running object's MLP: its
//    weights MN-major as they lie in the forward pack (a slice is a 64-row
//    block of W_l, two 64 x 64 boxes), the epilogue (bias, cond_lin rows at
//    head_0, relu, bf16) writing the activation tile in place, TMA stores of
//    it overlapping the next layer when saving, the 1- and 3-wide heads on
//    the CUDA cores, and the gated rgb and density summed in registers in
//    object order. The warpgroups take turns on the tensor cores (K1's
//    ping-pong).
//  * obj_mlp_bwd_kernel (K4's tile kernel): per running object K2's reverse
//    walk (G_l W_l^T with the forward pack as the K-major B, masks arriving
//    by TMA, G leaving by TMA stores) with the output cotangents scaled by
//    hit_o; dx of the x-parts (layer 0, the skip layer) summed over objects
//    in registers in walk and object order and stored once per tile.
//
// The mask-free builds. At 128 / 128, K1 is K3 with one object whose hit
// mask is all ones, and K2 is K4 for that object; K5 and K6, the MLP with
// its input gated in the kernel, are K1 and K2 with the blend. The kernels'
// TAG picks the build: 3 and 4 (K3, K4) read `hit`, evaluate the pair
// predicate and scale by the gates; 1 and 2 (K1 and K2 at 128 / 128,
// fused_mlp.cu and fused_mlp_bwd.cu) run their one object on every tile,
// read no mask and scale nothing, and their weight gradients take
// wide_dw_kernel without the object axis, which skips no stage; 5 and 6
// (K5 and K6, fused_mlp_gated.cu and fused_mlp_gated_bwd.cu) are 1 and 2
// with the gate (GateArgs):
//  * TAG 5 forms its input tile from bf16 rows x [n][F] as bf16(g x + (1 -
//    g) fill) in the prologue (gated_input), saves that blended tile for
//    K6's dW, and writes row-major outputs [n][C];
//  * TAG 6 runs TAG 2's walk on the blended residuals, then the gate's vjp
//    in registers on the x-parts' summed dx (gate_epilogue): dgate per
//    sample, per-tile partials of dfill that feature_sum_kernel adds in a
//    fixed order, and dx = g dxe.
// No tile is skipped: a row with gate 0 still runs the MLP on the fill row.
// The TAG also names the launch in a profile (profile.py), so that each
// kernel's time is counted as its own.

#pragma once

#include "mlp_wide.cuh"

namespace durf {
namespace obj {

using wide::Plan;
using wide::ROWS;
using wide::Slice;

constexpr int WIDTH = 128;                      // trunk and head width
constexpr int TILE_BYTES = ROWS * WIDTH * 2;     // a 128 x 128 bf16 tile
constexpr int SLICE = 16384;                     // one ring stage
constexpr int STAGES = 4;
constexpr int HEADS_FLOATS = 2 * WIDTH * 4;  // K3: one warpgroup's staged head weights
constexpr int RED_FLOATS = 8 * WIDTH;        // K6: the gate epilogue's per-warp dfill sums
// Map slots (hopper_mlp.py O_* and OB_*).
enum { O_XSAVE = 0, O_ACT = 1, O_W = 2 };
enum { OB_ACT = 0, OB_G = 1, OB_W = 2, OB_WX = 3 };

struct ObjDesc {
  int in_dim, xc, depth, skip, dc, n_rgb, n_den, s_per_ray, n_obj;
  int act_planes, g_planes;  // planes of one object in the activation / cotangent maps
  long long n, n_rays;
  long long w_stride, b_stride;    // per-object strides of the weight and bias packs
  long long act_stride, g_stride;  // per-object strides of the workspaces (elements)
  long long g_rgb, g_den, g_h0;    // backward: the 8-wide head rows' and head_0's offsets in an object's G
  long long w_off[MAX_LAYERS];     // bf16 forward-pack offsets
  long long b_off[MAX_LAYERS];     // fp32 bias offsets
};

__host__ __device__ inline bool reads_x(const ObjDesc& d, int i) {
  return i == 0 || ((i - 1) % d.skip == 0 && (i - 1) > 0);
}

// The slices the consumers take per object, which the schedule must match.
__host__ inline int fwd_slices(const ObjDesc& d) {
  int s = 0;
  for (int i = 0; i < d.depth; ++i) s += (i > 0 ? 2 : 0) + (reads_x(d, i) ? d.xc : 0);
  return s + 2 + 2 * d.dc;
}
__host__ inline int bwd_slices(const ObjDesc& d, bool dx) {
  int s = 2 * d.dc + 2;
  for (int i = d.depth - 1; i >= 0; --i) s += (i > 0 ? 2 : 0) + (dx && reads_x(d, i) ? 2 * d.xc : 0);
  return s;
}

// Whether the tile at tile0 runs the object whose per-ray gates are hit_o.
__device__ __forceinline__ bool tile_runs(const float* hit_o, long long tile0, long long n, int s) {
  const long long r1 = (tile0 + ROWS - 1 < n ? tile0 + ROWS - 1 : n - 1) / s;
  for (long long r = tile0 / s; r <= r1; ++r)
    if (hit_o[r] != 0.f) return true;
  return false;
}

// This block's tiles are blockIdx.x + k gridDim.x, k < block_tiles(d). The
// kernels walk them by stride (no 64-bit division on the device).
__host__ __device__ inline long long block_tiles(const ObjDesc& d, long long block, long long grid) {
  const long long tiles = (d.n + ROWS - 1) / ROWS;
  return (tiles - block + grid - 1) / grid;
}

// Every thread: runs[k * n_obj + o] = whether the block's k-th tile runs
// object o; then a CTA barrier (which also publishes the mbarriers thread 0
// initialised).
__device__ __forceinline__ void block_pairs(unsigned char* runs, const float* hit, const ObjDesc& d) {
  const long long pairs = block_tiles(d, blockIdx.x, gridDim.x) * d.n_obj;
  for (long long i = threadIdx.x; i < pairs; i += blockDim.x) {
    const long long k = i / d.n_obj;
    const int o = (int)(i - k * d.n_obj);
    runs[i] = tile_runs(hit + o * d.n_rays, (blockIdx.x + k * gridDim.x) * ROWS, d.n, d.s_per_ray);
  }
  __syncthreads();
}

// The producer: for each tile of this block and each object the tile runs
// (HIT; without it, every tile runs its one object), the schedule, each
// slice BOXES boxes at c0 + 64 b, the object added to the plane.
template <int BOXES, bool HIT>
__device__ void produce(const Plan& plan, const unsigned char* runs, const ObjDesc& d,
                        unsigned char* stages, uint64_t* full, uint64_t* empty) {
  int i = 0;
  const long long n_tiles = (d.n + ROWS - 1) / ROWS;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, runs += d.n_obj) {
    for (int o = 0; o < d.n_obj; ++o) {
      if (HIT && !runs[o]) continue;
      for (int k = 0; k < plan.n_slices; ++k, ++i) {
        const int s = i % STAGES;
        hop::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        const Slice sl = plan.slices[k];
        const unsigned bytes = plan.box_bytes[sl.spec];
        hop::mbar_expect_tx(&full[s], BOXES * bytes);
        for (int b = 0; b < BOXES; ++b)
          hop::tma_load(stages + s * SLICE + b * bytes, &plan.maps[sl.spec], &full[s],
                        sl.c0 + 64 * b, sl.c1, sl.c2 + o);
      }
    }
  }
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  for (int s = 0; s < STAGES; ++s) {
    hop::mbar_init(&full[s], 1);
    hop::mbar_init(&empty[s], wide::CONSUMER_WARPS);
  }
}

// ---- K3 ----

// After a layer's products: the epilogue writes the activation tile in
// place and, with `save`, a TMA store sends it to activation plane `plane`.
template <bool RELU, bool COND>
__device__ __forceinline__ void fwd_layer(const float (&acc)[WIDTH / 2], unsigned char* act,
                                          const float* bias, const float* cond, const Plan& plan,
                                          int save, int plane, long long tile0, long long n,
                                          int s_per_ray, int wg, int t) {
  wide::before_overwrite(wg, t);
  wide::fwd_epilogue<WIDTH, RELU, COND>(acc, act, bias, cond, tile0, n, s_per_ray, wg, t);
  wide::after_write(wg);
  if (save) wide::store_rows(&plan.maps[O_ACT], act, WIDTH / 64, tile0, plane, wg, t);
}

// The 1- and 3-wide heads (c_out <= 4) of the object MLPs on the CUDA
// cores. Their weights are staged per object as fp32 [WIDTH][4] in the
// warpgroup's own scratch (`heads`: density, then rgb), so that a thread
// reads them as broadcast float4s; the two threads of a row each sum half
// of its columns, read as 16-byte chunks of the swizzled tile, and combine
// with a shuffle. The sums run in wide::small_head_wide's order.
__device__ __forceinline__ void stage_heads(float* heads, const bf16* w_den, int n_den,
                                            const bf16* w_rgb, int n_rgb, int t) {
  for (int i = t; i < WIDTH * 4; i += 128) {
    const int k = i >> 2, c = i & 3;
    heads[i] = c < n_den ? __bfloat162float(w_den[k * n_den + c]) : 0.f;
    heads[WIDTH * 4 + i] = c < n_rgb ? __bfloat162float(w_rgb[k * n_rgb + c]) : 0.f;
  }
}
__device__ __forceinline__ void small_head(const unsigned char* tile, const float* w4,
                                           const float* bias, int c_out, int wg, int t,
                                           float (&out)[4]) {
  const int row = 64 * wg + (t >> 1), half = t & 1;
  const unsigned char* r = tile + half * ROWS * 128 + row * 128;  // column block `half` of the row
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint4 v = *reinterpret_cast<const uint4*>(r + ((q ^ (row & 7)) << 4));
    const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float h = (e & 1) ? __high2float(v2[e >> 1]) : __low2float(v2[e >> 1]);
      const float4 w = *reinterpret_cast<const float4*>(w4 + 4 * (half * 64 + 8 * q + e));
      s[0] = fmaf(h, w.x, s[0]);
      s[1] = fmaf(h, w.y, s[1]);
      s[2] = fmaf(h, w.z, s[2]);
      s[3] = fmaf(h, w.w, s[3]);
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    s[c] += __shfl_xor_sync(0xffffffffu, s[c], 1);
    out[c] = c < c_out ? s[c] + bias[c] : 0.f;
  }
}

// TAG 5's input tile, the warpgroup's 64 rows of bf16(g x + (1 - g) fill)
// from the bf16 rows x [n][in_dim] and the fill row, g the row's per-ray
// gate, formed in fp32 without fused multiply-add (as the plain version
// computes it); zero past in_dim and n. A warp takes every fourth row, four
// rows at a time, its lanes neighbouring features: coalesced 2-byte loads
// along the row (126 bytes at F_in 63, a stride TMA does not take), one
// gate load a row.
template <int XC>
__device__ __forceinline__ void gated_input(unsigned char* xt, const GateArgs& ga,
                                            const ObjDesc& d, long long tile0, int wg, int t) {
  const int lane = t & 31, warp = t >> 5;
  float fill[2 * XC];
#pragma unroll
  for (int q = 0; q < 2 * XC; ++q) {
    const int f = lane + 32 * q;
    fill[q] = f < d.in_dim ? __bfloat162float(ga.fill[f]) : 0.f;
  }
#pragma unroll 1
  for (int k0 = 0; k0 < 16; k0 += 4) {
    float g[4], v[4][2 * XC];
    bool ok[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long s = tile0 + 64 * wg + warp + 4 * (k0 + u);
      ok[u] = s < d.n;
      g[u] = ok[u] ? ga.gate[wide::ray_of(s, d.s_per_ray)] : 0.f;
      const bf16* xr = ga.x + (ok[u] ? s : 0) * d.in_dim;
#pragma unroll
      for (int q = 0; q < 2 * XC; ++q) {
        const int f = lane + 32 * q;
        v[u][q] = ok[u] && f < d.in_dim ? __bfloat162float(xr[f]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int row = 64 * wg + warp + 4 * (k0 + u);
#pragma unroll
      for (int q = 0; q < 2 * XC; ++q) {
        const int f = lane + 32 * q;
        const float e = __fadd_rn(__fmul_rn(g[u], v[u][q]), __fmul_rn(1.f - g[u], fill[q]));
        *reinterpret_cast<bf16*>(xt + hop::swz(ROWS, row, f)) =
            __float2bfloat16_rn(ok[u] && f < d.in_dim ? e : 0.f);
      }
    }
  }
}

// One tile of K3 on the consumer warpgroups: the shared input tile (if
// some object runs), each running object's MLP, the gated sums. Without
// HIT (K1, K5): the one object's MLP, its outputs as they are, and the
// heads' weights staged once per block by the caller; K5 (GATE) blends its
// input tile and writes row-major outputs.
template <int TAG, int XC>
__device__ __forceinline__ void fwd_tile(long long tile0, const unsigned char* runs,
                                         const float* __restrict__ x,
                                         const float* __restrict__ hit,
                                         const float* __restrict__ cond_lin,
                                         const bf16* __restrict__ w, const float* __restrict__ b,
                                         float* __restrict__ rgb_out, float* __restrict__ den_out,
                                         int save, const GateArgs& ga, const Plan& plan,
                                         const ObjDesc& d, unsigned char* act, unsigned char* xt,
                                         float* heads, wide::Ring<STAGES, SLICE>& ring, int wg,
                                         int t) {
  constexpr bool HIT = TAG == 3, GATE = TAG == 5;
  const long long n = d.n;
  const long long sample = tile0 + 64 * wg + (t >> 1);  // this thread's row of the heads
  const int ray = sample < n ? wide::ray_of(sample, d.s_per_ray) : 0;
  float rgb_acc[4] = {0.f, 0.f, 0.f, 0.f}, den_acc[4] = {0.f, 0.f, 0.f, 0.f};
  bool any = !HIT;
  for (int o = 0; HIT && o < d.n_obj; ++o) any |= runs[o] != 0;
  if (any) {
    wide::before_overwrite(wg, t);  // the last tile's stores have read the x and activation tiles
    if constexpr (GATE) gated_input<XC>(xt, ga, d, tile0, wg, t);
    // Else the input tile: feature-major fp32 -> bf16 rows, zero past in_dim and n.
    for (int i0 = t; !GATE && i0 < XC * 64 * 64; i0 += 8 * 128) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * 128, f = i >> 6, r = i & 63;
        const long long s = tile0 + 64 * wg + r;
        v[u] = (f < d.in_dim && s < n) ? x[(long long)f * n + s] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * 128, f = i >> 6, r = i & 63;
        *reinterpret_cast<bf16*>(xt + hop::swz(ROWS, 64 * wg + r, f)) = __float2bfloat16_rn(v[u]);
      }
    }
    wide::after_write(wg);
    if (save) wide::store_rows(&plan.maps[O_XSAVE], xt, XC, tile0, 0, wg, t);
    const int l_rgb = d.depth + 2 + d.dc;
    float acc[WIDTH / 2];
    for (int o = 0; o < d.n_obj; ++o) {
      if (HIT && !runs[o]) continue;
      const bf16* wo = w + o * d.w_stride;
      const float* bo = b + o * d.b_stride;
      const float* co = cond_lin + o * d.n_rays * WIDTH;
      const int z = o * d.act_planes;
      for (int i = 0; i < d.depth; ++i) {
        wide::zero(acc);
        if (i > 0) wide::product<WIDTH, STAGES, true, true, SLICE>(acc, act, WIDTH / 64, ring, wg);
        if (reads_x(d, i)) wide::product<WIDTH, STAGES, true, true, SLICE>(acc, xt, XC, ring, wg);
        fwd_layer<true, false>(acc, act, bo + d.b_off[i], co, plan, save, z + i, tile0, n,
                               d.s_per_ray, wg, t);
        if (HIT && i == 0) {  // the heads' weights: the last object's rgb head has read them
          stage_heads(heads, wo + d.w_off[d.depth], d.n_den, wo + d.w_off[l_rgb], d.n_rgb, t);
          hop::named_sync(1 + wg, 128);
        }
      }
      float den[4], rgb[4];
      small_head(act, heads, bo + d.b_off[d.depth], d.n_den, wg, t, den);
      wide::zero(acc);  // bottleneck, no activation
      wide::product<WIDTH, STAGES, true, true, SLICE>(acc, act, WIDTH / 64, ring, wg);
      fwd_layer<false, false>(acc, act, bo + d.b_off[d.depth + 1], co, plan, save, z + d.depth,
                              tile0, n, d.s_per_ray, wg, t);
      for (int i = 0; i < d.dc; ++i) {
        wide::zero(acc);
        wide::product<WIDTH, STAGES, true, true, SLICE>(acc, act, WIDTH / 64, ring, wg);
        const float* bias = bo + d.b_off[d.depth + 2 + i];
        if (i == 0)
          fwd_layer<true, true>(acc, act, bias, co, plan, save, z + d.depth + 1, tile0, n,
                                d.s_per_ray, wg, t);
        else
          fwd_layer<true, false>(acc, act, bias, co, plan, save, z + d.depth + 1 + i, tile0, n,
                                 d.s_per_ray, wg, t);
      }
      small_head(act, heads + WIDTH * 4, bo + d.b_off[l_rgb], d.n_rgb, wg, t, rgb);
      const float g = HIT ? hit[o * d.n_rays + ray] : 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        rgb_acc[c] = HIT ? rgb_acc[c] + g * rgb[c] : rgb[c];
        den_acc[c] = HIT ? den_acc[c] + g * den[c] : den[c];
      }
    }
  }
  if ((t & 1) == 0 && sample < n) {  // K5: row-major [n][C]; else feature-major [C][n]
    for (int c = 0; c < d.n_rgb; ++c) rgb_out[GATE ? sample * d.n_rgb + c : c * n + sample] = rgb_acc[c];
    for (int c = 0; c < d.n_den; ++c) den_out[GATE ? sample * d.n_den + c : c * n + sample] = den_acc[c];
  }
}

// TAG 3: K3; TAG 1: K1 at 128 / 128 (one object, every tile, hit unread);
// TAG 5: K5 at 128 / 128 (TAG 1 on the input gated in the tile, x unread).
template <int TAG, int XC>
__global__ void __launch_bounds__(wide::THREADS_TILE, 1)
    obj_mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ hit,
                       const float* __restrict__ cond_lin, const bf16* __restrict__ w,
                       const float* __restrict__ b, float* __restrict__ rgb_out,
                       float* __restrict__ den_out, int save, const __grid_constant__ GateArgs ga,
                       const __grid_constant__ Plan plan, const __grid_constant__ ObjDesc d) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* act = wide::align1024(smem_raw);
  unsigned char* xt = act + TILE_BYTES;
  unsigned char* stages = xt + XC * ROWS * 128;
  float* heads = reinterpret_cast<float*>(stages + STAGES * SLICE);  // [2 warpgroups][2][WIDTH][4]
  uint64_t* full = reinterpret_cast<uint64_t*>(heads + 2 * HEADS_FLOATS);
  uint64_t* empty = full + STAGES;
  unsigned char* runs = reinterpret_cast<unsigned char*>(empty + STAGES);
  constexpr bool HIT = TAG == 3;
  if (threadIdx.x == 0) {
    init_ring(full, empty);
    hop::mbar_init_fence();
  }
  if (HIT)
    block_pairs(runs, hit, d);
  else
    __syncthreads();
  if (threadIdx.x >= 256) {
    hop::setmaxnreg_dec<wide::PRODUCER_REGS>();
    if (threadIdx.x == 256) produce<2, HIT>(plan, runs, d, stages, full, empty);
    return;
  }
  hop::setmaxnreg_inc<wide::CONSUMER_REGS>();
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  wide::Ring<STAGES, SLICE> ring{stages, full, empty, 0};
  if (!HIT) {  // one object: its heads' weights, once
    stage_heads(heads + wg * HEADS_FLOATS, w + d.w_off[d.depth], d.n_den,
                w + d.w_off[d.depth + 2 + d.dc], d.n_rgb, t);
    hop::named_sync(1 + wg, 128);
  }
  if (wg == 1) hop::named_arrive(3, 256);  // warpgroup 0 takes the first turn
  const long long n_tiles = (d.n + ROWS - 1) / ROWS;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, runs += d.n_obj)
    fwd_tile<TAG, XC>(tile * ROWS, runs, x, hit, cond_lin, w, b, rgb_out, den_out, save, ga, plan,
                      d, act, xt, heads + wg * HEADS_FLOATS, ring, wg, t);
  if (wg == 0) hop::named_sync(3, 256);  // warpgroup 1's arrival after its last turn
  if (t == 0) hop::tma_store_wait_read();
}

// ---- K4: the tile kernel ----

// One step of the reverse walk: acc = G W_l^T over the next two slices
// while (MASK) the activation plane `mask_plane` arrives for the relu
// mask; the epilogue (DEN: with the density head's term, its cotangents
// scaled by the object's gates with HIT) writes G_{l-1} into gt, and a TMA
// store sends it to cotangent plane `g_plane`.
template <bool MASK, bool DEN, bool HIT>
__device__ __forceinline__ void bwd_step(float (&acc)[WIDTH / 2], unsigned char* gt,
                                         unsigned char* mt, const Plan& plan,
                                         wide::Ring<STAGES, SLICE>& ring, uint64_t* bar,
                                         int& mphase, int mask_plane, int g_plane,
                                         const float* g_den, const bf16* w_den, int n_den,
                                         const float* hit_o, int s_per_ray, long long tile0,
                                         long long n, int wg, int t) {
  if (MASK) wide::load_rows(&plan.maps[OB_ACT], mt, WIDTH / 64, tile0, mask_plane, bar, wg, t);
  wide::zero(acc);
  wide::product<WIDTH, STAGES, false, false, SLICE>(acc, gt, WIDTH / 64, ring, wg);
  if (MASK) {
    hop::mbar_wait(bar, mphase);
    mphase ^= 1;
  }
  wide::before_overwrite(wg, t);
  wide::bwd_epilogue<WIDTH, MASK, DEN, DEN && HIT>(acc, gt, mt, g_den, w_den, n_den, tile0, n, wg,
                                                   t, hit_o, s_per_ray);
  wide::after_write(wg);
  wide::store_rows(&plan.maps[OB_G], gt, WIDTH / 64, tile0, g_plane, wg, t);
}

// K6's gate epilogue: the gate's vjp on the tile, in registers, once the
// reverse walk has summed the blend's cotangent dxe over the x-parts into
// dxa (this thread's rows 64 wg + acc_row(t, i), columns 64 c + acc_col(t,
// j) and the next, in the wgmma accumulator's layout):
//  * dgate[s] = sum_f (x'[s][f] - fill'[f]) dxe[s][f]: the thread's columns
//    in order, then the quad of lanes that shares the row (xor 1, 2);
//  * dfill_part[f][tile] = sum over the tile's rows of (1 - g) dxe[., f]:
//    the thread's two rows, the 8 lanes that share its columns (xor 4, 8,
//    16), then the 8 consumer warps in order through `red` ([8][128] fp32),
//    between two barriers of both warpgroups. Indexed by tile, not block: a
//    persistent block walks many tiles;
//  * dxa scaled by g, which the caller stores as dx.
// Rows at or past n add 0 to both sums; columns at or past in_dim (whose
// dxa holds the next pack rows' products) are read by neither.
template <int XC>
__device__ __forceinline__ void gate_epilogue(float (&dxa)[XC][32], const GateArgs& ga,
                                              const ObjDesc& d, long long tile0, float* red,
                                              int wg, int t) {
  const int lane = t & 31, warp = t >> 5;
  long long sample[2];
  bool valid[2];
  float g[2], omg[2], dg[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sample[i] = tile0 + 64 * wg + hop::acc_row(t, i);
    valid[i] = sample[i] < d.n;
    g[i] = valid[i] ? ga.gate[wide::ray_of(sample[i], d.s_per_ray)] : 0.f;
    omg[i] = valid[i] ? 1.f - g[i] : 0.f;
  }
#pragma unroll
  for (int c = 0; c < XC; ++c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = 64 * c + hop::acc_col(t, j);
      float fl[2], xv[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        fl[e] = f + e < d.in_dim ? __bfloat162float(ga.fill[f + e]) : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          xv[i][e] = valid[i] && f + e < d.in_dim
                         ? __bfloat162float(ga.x[sample[i] * d.in_dim + f + e])
                         : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (valid[i] && f + e < d.in_dim)
            dg[i] = fmaf(xv[i][e] - fl[e], dxa[c][4 * j + 2 * i + e], dg[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dg[i] += __shfl_xor_sync(0xffffffffu, dg[i], 1);
    dg[i] += __shfl_xor_sync(0xffffffffu, dg[i], 2);
    if ((t & 3) == 0 && valid[i]) ga.dgate[sample[i]] = dg[i];
  }
  float* mine = red + (4 * wg + warp) * WIDTH;
  hop::named_sync(3, 256);  // the last tile's sums have read red
#pragma unroll
  for (int c = 0; c < XC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = fmaf(omg[1], dxa[c][4 * j + 2 + e], omg[0] * dxa[c][4 * j + e]);
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 4) mine[64 * c + hop::acc_col(t, j) + e] = v;
      }
  hop::named_sync(3, 256);  // red holds every warp's sums
  const int f = 128 * wg + t;
  if (f < 64 * XC && f < d.in_dim) {
    float s = 0.f;
    for (int k = 0; k < 8; ++k) s += red[k * WIDTH + f];
    ga.dfill_part[(long long)f * ((d.n + ROWS - 1) / ROWS) + tile0 / ROWS] = s;
  }
#pragma unroll
  for (int c = 0; c < XC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        dxa[c][4 * j + 2 * i] *= g[i];
        dxa[c][4 * j + 2 * i + 1] *= g[i];
      }
}

// One tile of K4's tile kernel on the consumer warpgroups: each running
// object's reverse walk, then the tile's dx rows (zeros if none runs).
// Without HIT (K2, K6): the one object's walk, its cotangents unscaled; K6
// (GATE) runs the gate epilogue before dx is stored.
template <int TAG, int XC>
__device__ __forceinline__ void bwd_tile(long long tile0, const unsigned char* runs,
                                         const float* __restrict__ g_rgb,
                                         const float* __restrict__ g_den,
                                         const float* __restrict__ hit, const bf16* __restrict__ w,
                                         const bf16* __restrict__ act, bf16* __restrict__ g,
                                         float* __restrict__ dx, const GateArgs& ga,
                                         const Plan& plan, const ObjDesc& d, unsigned char* gt,
                                         unsigned char* mt, float* red,
                                         wide::Ring<STAGES, SLICE>& ring, uint64_t* bar,
                                         int& mphase, int wg, int t) {
  constexpr bool HIT = TAG == 4;
  const long long n = d.n;
  const int l_h0 = d.depth + 2;
  float acc[WIDTH / 2];
  float dxa[XC][32];  // this thread's dx elements, summed over the x-parts and objects
#pragma unroll
  for (int c = 0; c < XC; ++c) wide::zero(dxa[c]);
  for (int o = 0; o < d.n_obj; ++o) {
    if (HIT && !runs[o]) continue;
    const float* hit_o = HIT ? hit + o * d.n_rays : nullptr;
    const bf16* wo = w + o * d.w_stride;
    bf16* go = g + o * d.g_stride;
    const int za = o * d.act_planes, zg = o * d.g_planes;
    wide::before_overwrite(wg, t);  // the last G store has read gt
    wide::rgb_head_bwd_wide<HIT>(gt, reinterpret_cast<float*>(mt + wg * 64 * 128),
                                 act + o * d.act_stride + (long long)(d.depth + d.dc) * WIDTH * n,
                                 wo + d.w_off[l_h0 + d.dc], d.n_rgb, g_rgb, g_den, d.n_den,
                                 go + d.g_rgb, go + d.g_den, tile0, n, wg, t, hit_o, d.s_per_ray);
    wide::after_write(wg);
    wide::store_rows(&plan.maps[OB_G], gt, WIDTH / 64, tile0, zg + d.depth + d.dc, wg, t);
    for (int i = d.dc - 1; i >= 1; --i)  // head_i -> head_{i-1}
      bwd_step<true, false, HIT>(acc, gt, mt, plan, ring, bar, mphase, za + d.depth + i,
                                 zg + d.depth + i, g_den, wo, 0, hit_o, d.s_per_ray, tile0, n, wg,
                                 t);
    // head_0 -> bottleneck (no activation)
    bwd_step<false, false, HIT>(acc, gt, mt, plan, ring, bar, mphase, 0, zg + d.depth, g_den, wo,
                                0, hit_o, d.s_per_ray, tile0, n, wg, t);
    // bottleneck and density head -> trunk_{depth-1}
    bwd_step<true, true, HIT>(acc, gt, mt, plan, ring, bar, mphase, za + d.depth - 1,
                              zg + d.depth - 1, g_den, wo + d.w_off[d.depth], d.n_den, hit_o,
                              d.s_per_ray, tile0, n, wg, t);
    for (int i = d.depth - 1; i >= 0; --i) {
      if (reads_x(d, i) && dx != nullptr) {  // the products accumulate onto dxa
#pragma unroll
        for (int c = 0; c < XC; ++c)
          wide::product<64, STAGES, false, false, SLICE>(dxa[c], gt, WIDTH / 64, ring, wg);
      }
      if (i == 0) break;
      bwd_step<true, false, HIT>(acc, gt, mt, plan, ring, bar, mphase, za + i - 1, zg + i - 1, g_den,
                                 wo, 0, hit_o, d.s_per_ray, tile0, n, wg, t);
    }
  }
  if constexpr (TAG == 6) gate_epilogue<XC>(dxa, ga, d, tile0, red, wg, t);
  if (dx != nullptr) {
#pragma unroll
    for (int c = 0; c < XC; ++c) wide::dx_accumulate(dxa[c], dx, c, d.in_dim, tile0, n, true, wg, t);
  }
}

// TAG 4: K4's tile kernel; TAG 2: K2's at 128 / 128 (one object, every
// tile, hit unread); TAG 6: K6's (TAG 2 and the gate epilogue).
template <int TAG, int XC>
__global__ void __launch_bounds__(wide::THREADS_TILE, 1)
    obj_mlp_bwd_kernel(const float* __restrict__ g_rgb, const float* __restrict__ g_den,
                       const float* __restrict__ hit, const bf16* __restrict__ w,
                       const bf16* __restrict__ act, bf16* __restrict__ g, float* __restrict__ dx,
                       const __grid_constant__ GateArgs ga, const __grid_constant__ Plan plan,
                       const __grid_constant__ ObjDesc d) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* gt = wide::align1024(smem_raw);
  unsigned char* mt = gt + TILE_BYTES;
  unsigned char* stages = mt + TILE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + STAGES * SLICE);
  uint64_t* empty = full + STAGES;
  uint64_t* mbar = empty + STAGES;  // one per warpgroup: its activation rows
  float* red = reinterpret_cast<float*>(mbar + 2);  // K6: the gate epilogue's [8][128] sums
  unsigned char* runs = reinterpret_cast<unsigned char*>(red + (TAG == 6 ? RED_FLOATS : 0));
  constexpr bool HIT = TAG == 4;
  if (threadIdx.x == 0) {
    init_ring(full, empty);
    hop::mbar_init(&mbar[0], 1);
    hop::mbar_init(&mbar[1], 1);
    hop::mbar_init_fence();
  }
  if (HIT)
    block_pairs(runs, hit, d);
  else
    __syncthreads();
  if (threadIdx.x >= 256) {
    hop::setmaxnreg_dec<wide::PRODUCER_REGS>();
    if (threadIdx.x == 256) produce<1, HIT>(plan, runs, d, stages, full, empty);
    return;
  }
  hop::setmaxnreg_inc<wide::CONSUMER_REGS>();
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  wide::Ring<STAGES, SLICE> ring{stages, full, empty, 0};
  int mphase = 0;
  const long long n_tiles = (d.n + ROWS - 1) / ROWS;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, runs += d.n_obj)
    bwd_tile<TAG, XC>(tile * ROWS, runs, g_rgb, g_den, hit, w, act, g, dx, ga, plan, d, gt, mt, red,
                      ring, &mbar[wg], mphase, wg, t);
  if (t == 0) hop::tma_store_wait_read();
}

// ---- host ----

// Persistent blocks: one per SM, at most one per tile.
inline unsigned grid_of(const ObjDesc& d) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = (d.n + ROWS - 1) / ROWS;
  return (unsigned)(tiles < sms ? tiles : sms);
}
// The pair flags of block 0, which has the most tiles.
inline size_t runs_bytes(const ObjDesc& d) { return (size_t)(block_tiles(d, 0, grid_of(d)) * d.n_obj); }
inline size_t fwd_smem(const ObjDesc& d) {
  return 1024 + TILE_BYTES + (size_t)d.xc * ROWS * 128 + STAGES * SLICE + 2 * HEADS_FLOATS * 4 +
         2 * STAGES * 8 + runs_bytes(d);
}
inline size_t bwd_smem(const ObjDesc& d, bool gated) {
  return 1024 + 2 * TILE_BYTES + STAGES * SLICE + (2 * STAGES + 2) * 8 + (gated ? RED_FLOATS * 4 : 0) +
         runs_bytes(d);
}

// The descriptor from the entry points' arguments; -1 where the kernels do
// not take the shape.
inline int make_desc(ObjDesc& d, int in_dim, int width, int depth, int skip, int wc, int dc,
                     int n_rgb, int n_den, const long long* w_off, const long long* b_off,
                     int n_layers, long long n, long long n_rays, int s_per_ray, int n_obj,
                     long long w_stride, long long b_stride, long long act_stride) {
  if (width != WIDTH || wc != WIDTH || n_layers != depth + dc + 3 || n_layers > MAX_LAYERS ||
      n >= wide::MAX_SAMPLES)
    return -1;
  d = ObjDesc{};
  d.in_dim = in_dim;
  d.xc = (in_dim + 63) / 64;
  d.depth = depth;
  d.skip = skip;
  d.dc = dc;
  d.n_rgb = n_rgb;
  d.n_den = n_den;
  d.s_per_ray = s_per_ray;
  d.n_obj = n_obj;
  d.act_planes = depth + 1 + dc;
  d.g_planes = depth + 2 + dc;
  d.n = n;
  d.n_rays = n_rays;
  d.w_stride = w_stride;
  d.b_stride = b_stride;
  d.act_stride = act_stride;
  for (int l = 0; l < n_layers; ++l) {
    d.w_off[l] = w_off[l];
    d.b_off[l] = b_off == nullptr ? 0 : b_off[l];
  }
  return d.xc > 2 || n_rgb > 4 || n_den > 4 ? -1 : 0;
}

// Whether the saved activations lie one [n][128] plane per segment
// (act_layout), as the activation map reads them.
inline bool act_planes(const ObjDesc& d, const long long* act_off, int n_act) {
  if (n_act != d.act_planes) return false;
  for (int i = 0; i < n_act; ++i)
    if (act_off[i] != (long long)i * WIDTH * d.n) return false;
  return true;
}

// The cotangent workspace of g_layout (ops/kernels/fused_mlp.py): the
// 128-wide segments one [n][128] plane apart, the density and rgb rows in
// the last plane, g_stride elements an object (whole planes). Sets d's
// offsets into it; -1 for another layout.
inline int set_g_layout(ObjDesc& d, const long long* g_off, long long g_stride) {
  const long long plane = (long long)WIDTH * d.n;
  for (int l = 0; l < d.depth + d.dc + 3; ++l) {
    const bool head = l >= d.depth + 2 && l < d.depth + 2 + d.dc;
    const int p = l < d.depth ? l : l == d.depth + 1 ? d.depth : head ? l - 1 : -1;
    if (p >= 0 && g_off[l] != p * plane) return -1;
  }
  if (g_stride != d.g_planes * plane || g_off[d.depth] < (d.g_planes - 1) * plane) return -1;
  d.g_stride = g_stride;
  d.g_den = g_off[d.depth];
  d.g_rgb = g_off[d.depth + 2 + d.dc];
  d.g_h0 = g_off[d.depth + 2];
  return 0;
}

// The forward (TAG 3: K3, gated by `hit`; TAG 1: K1 at 128 / 128, hit
// nullptr; TAG 5: K5 at 128 / 128, x and hit nullptr, its input from `ga`)
// on the maps and one object's slice schedule the Python side built
// (hopper_mlp.obj_fwd_plan).
template <int TAG>
int launch_fwd(const float* x, const float* hit, const float* cond_lin, const bf16* w,
               const float* b, float* rgb, float* den, bf16* save_x, bf16* save_act,
               const ObjDesc& d, const long long* specs, int n_specs, const long long* slices,
               int n_slices, cudaStream_t stream, const GateArgs& ga = GateArgs{}) {
  constexpr bool GATE = TAG == 5;
  if ((hit != nullptr) != (TAG == 3) || (x == nullptr) != GATE ||
      (GATE && (ga.x == nullptr || ga.gate == nullptr || ga.fill == nullptr)) ||
      n_slices != fwd_slices(d))
    return -1;
  Plan plan;
  const void* bases[5] = {save_x, save_act, nullptr, w, nullptr};
  int err = wide::make_plan(plan, specs, n_specs, slices, n_slices, bases);
  if (err != 0) return err;
  const size_t smem = fwd_smem(d);
  auto kern = d.xc == 1 ? obj_mlp_fwd_kernel<TAG, 1> : obj_mlp_fwd_kernel<TAG, 2>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid_of(d), wide::THREADS_TILE, smem, stream>>>(x, hit, cond_lin, w, b, rgb, den,
                                                         save_act != nullptr, ga, plan, d);
  return (int)cudaGetLastError();
}

// The backward's launches (TAG 4: K4, gated by `hit`; TAG 2: K2 at 128 /
// 128, hit nullptr; TAG 6: K6, TAG 2 with the gate's vjp from `ga`): the
// tile kernel, the dW products over `a`'s job table (one object's jobs;
// with HIT per object, skipping the stages no ray of the object hits),
// their fixed-order reduction, the per-ray d cond_lin sums and (K6) the
// fixed-order dfill sum over tiles. a.total: the gradients of all objects.
template <int TAG>
int launch_bwd(const BwdArgs& a, const float* hit, const ObjDesc& d, const WideArgs& wa,
               cudaStream_t stream, const GateArgs& ga = GateArgs{}) {
  constexpr bool HIT = TAG == 4, GATE = TAG == 6;
  if ((hit != nullptr) != HIT || a.jobs_host == nullptr ||
      wa.n_slices != bwd_slices(d, a.dx != nullptr) ||
      (ga.gate != nullptr) != GATE ||
      (GATE && (a.dx == nullptr || ga.x == nullptr || ga.fill == nullptr || ga.dgate == nullptr ||
                ga.dfill_part == nullptr || ga.dfill == nullptr)))
    return -1;
  Plan plan;
  const void* bases[5] = {a.x_save, a.act, a.g, a.w, nullptr};
  int err = wide::make_plan(plan, wa.specs, wa.n_specs, wa.slices, wa.n_slices, bases);
  if (err != 0) return err;
  wide::DwPlan dwp;
  if ((err = wide::make_dw_plan(dwp, a.jobs_host, a.n_jobs, d.n, a.x_save, a.act, a.g, d.n_obj,
                                d.act_stride, d.g_stride)) != 0)
    return err;

  const size_t smem = bwd_smem(d, GATE);
  auto tile = d.xc == 1 ? obj_mlp_bwd_kernel<TAG, 1> : obj_mlp_bwd_kernel<TAG, 2>;
  cudaError_t ce = cudaFuncSetAttribute(tile, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  tile<<<grid_of(d), wide::THREADS_TILE, smem, stream>>>(a.g_rgb, a.g_den, hit, a.w, a.act, a.g,
                                                        a.dx, ga, plan, d);
  if ((err = (int)cudaGetLastError()) != 0) return err;

  const size_t dsmem = wide::dw_smem(HIT ? (size_t)((a.chunk + wide::DW_BK - 1) / wide::DW_BK) : 0);
  auto dwk = wide::wide_dw_kernel<TAG, HIT>;
  ce = cudaFuncSetAttribute(dwk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dsmem);
  if (ce != cudaSuccess) return (int)ce;
  dwk<<<(unsigned)((long long)a.n_tiles * d.n_obj * a.n_splits), wide::THREADS_DW, dsmem, stream>>>(
      a.jobs, a.n_jobs, a.n_tiles, d.n, a.chunk, a.part, a.total, dwp, hit, d.n_obj, d.n_rays,
      d.s_per_ray, a.total / d.n_obj);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  if ((err = launch_reduce<TAG>(a, stream)) != 0) return err;
  ray_sum_kernel<TAG><<<dim3((unsigned)d.n_rays, (unsigned)d.n_obj), WIDTH, 0, stream>>>(
      a.g, d.g_stride, d.g_h0, WIDTH, d.s_per_ray, d.n_rays, a.dcond, hit);
  if ((err = (int)cudaGetLastError()) != 0 || !GATE) return err;
  feature_sum_kernel<TAG><<<(unsigned)d.in_dim, THREADS, 0, stream>>>(
      ga.dfill_part, (int)((d.n + ROWS - 1) / ROWS), ga.dfill);
  return (int)cudaGetLastError();
}

// K2 (TAG 2) and K6 (TAG 6) at 128 / 128: one object of K4's launches on
// the residuals K1 or K5 saved, one [n][128] plane per segment, and the
// cotangent workspace of whole planes; -1 for another layout.
template <int TAG>
int launch_narrow_bwd(const BwdArgs& a, const MlpDesc& d, const BwdDesc& e, const GateArgs& ga,
                      const WideArgs& wa, cudaStream_t stream) {
  ObjDesc od;
  if (make_desc(od, d.in_dim, d.width, d.depth, d.skip, d.wc, d.depth_cond, d.n_rgb, d.n_den,
                d.w_off, nullptr, d.depth + d.depth_cond + 3, a.n, a.n_rays, a.s_per_ray, 1, 0, 0,
                0) != 0 ||
      !act_planes(od, d.act_off, od.act_planes) ||
      set_g_layout(od, e.g_off, od.g_planes * WIDTH * a.n) != 0)
    return -1;
  return launch_bwd<TAG>(a, nullptr, od, wa, stream, ga);
}

}  // namespace obj
}  // namespace durf
