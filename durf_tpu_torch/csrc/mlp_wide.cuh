// K1 and K2 at the flagship widths (8x256 trunk, head 128) on Hopper's
// wgmma with operands staged by TMA (sm_90a). The object-width kernels
// (mlp_obj.cuh: K3 and K4, and K1, K2, K5 and K6 at 128 / 128) build on the
// same ring, products and epilogues; their weight gradients are
// wide_dw_kernel, K4's with the object axis (OBJ).
//
// The tile kernels run three warpgroups: two consumers and a producer, which
// gives registers up to the consumers (setmaxnreg 40 and 232: ptxas reports
// the launch's 168 a thread, and the consumers' code uses up to 232); the dW
// kernel two consumers and a producer warp. The producer walks a schedule of weight (or operand)
// slices that the Python side builds (ops/kernels/hopper_mlp.py) and keeps
// TMA loads in flight through a ring of shared-memory stages, each guarded
// by a `full` mbarrier (the TMA's bytes arrived) and an `empty` one (all 8
// consumer warps are done with it). The consumers never meet at a CTA-wide
// barrier: each warpgroup owns 64 rows of the 128-sample tile and syncs
// only its own 128 threads (named barriers 1 and 2). A consumer warp
// releases a stage once `wgmma.wait_group` shows that the products reading
// it have finished, one slice behind the one it issues.
//
//  * wide_mlp_fwd_kernel (K1): the tile's activations stay in shared memory
//    in the swizzled layout wgmma reads as its A operand; each layer's
//    epilogue (bias, per-ray condition rows for head_0, relu, bf16) writes
//    them back in place, and with `save` a TMA store sends the same tile to
//    the activation workspace while the next layer's product runs. B is the
//    transposed weight pack, K-major.
//  * wide_mlp_bwd_kernel (K2's tile kernel): the reverse walk. G_l (bf16)
//    in shared memory is A; B is the forward pack, which is already the
//    K-major operand of G_l W_l^T. The saved activation tile of layer l - 1
//    arrives by TMA while layer l's product runs, so the relu mask is read
//    from shared memory; G_{l-1} goes out by a TMA store from the tile the
//    next product reads.
//  * wide_dw_kernel (K2's, K4's and K6's weight gradients): dW = A^T G over a slice of
//    samples per block, 128 x N output tiles (N = the layer's 64, 128 or
//    256 columns) over the two warpgroups, both operands MN-major (samples
//    are rows in device memory), 64 samples a stage, 4 stages. The row tiles
//    of one (layer, slice) are neighbours in the grid, so the G slab they
//    share is read from device memory about once. fp32 partials per slice,
//    summed in a fixed order by reduce_kernel: bitwise reproducible.

#pragma once

#include "hopper.cuh"
#include "mlp_bwd.cuh"

namespace durf {
namespace wide {

using hop::acc_col;
using hop::acc_row;
using hop::swz;

constexpr int W = 256, WC = 128;          // the widths these kernels take
constexpr int ROWS = 128;                 // samples per tile, 64 per warpgroup
constexpr int THREADS_TILE = 384;         // 2 consumer warpgroups + 1 producer warpgroup
constexpr int THREADS_DW = 288;           // 2 consumer warpgroups + 1 producer warp
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int CONSUMER_WARPS = 8;
constexpr int SLICE_BYTES = 32768;        // one weight slice: <= 256 rows x 64 columns
constexpr int FWD_STAGES = 4, BWD_STAGES = 3;
// Kept so that a launch's parameters stay within 4 KB.
constexpr int MAX_MAPS = 16, MAX_SLICES = 64, MAX_JOBS = 14;
constexpr int TILE_BYTES = ROWS * W * 2;  // a 128 x 256 bf16 tile
constexpr int DW_BK = 64;                 // samples per dW stage
constexpr int DW_BOX = DW_BK * 128;       // one 64-column box of a dW stage
constexpr int DW_STAGE = 6 * DW_BOX;      // 2 A boxes + up to 4 G boxes
constexpr int DW_STAGES = 4;

// Buffer ids of MapSpec::buf.
enum { BUF_XSAVE = 0, BUF_ACT = 1, BUF_G = 2, BUF_W = 3, BUF_WT = 4 };
// Fixed map slots: K1's x_save, activation (trunk and bottleneck), head
// activation maps; K2's activation, head activation, cotangent, head
// cotangent maps. Weight maps follow.
enum { F_XSAVE = 0, F_ACT = 1, F_ACT_HEAD = 2 };
enum { B_ACT = 0, B_ACT_HEAD = 1, B_G = 2, B_G_HEAD = 3 };

struct Slice {
  int spec, c0, c1, c2;
};

// The tensor maps and the producer's slice schedule of one tile kernel.
struct Plan {
  CUtensorMap maps[MAX_MAPS];
  Slice slices[MAX_SLICES];
  unsigned box_bytes[MAX_MAPS];
  int n_slices;
};

struct DwPlan {
  CUtensorMap a[MAX_JOBS];
  CUtensorMap g[MAX_JOBS];
};

struct WideDesc {
  int in_dim, xc, depth, skip, dc, n_rgb, n_den, s_per_ray;
  long long n;
  long long b_off[MAX_LAYERS];  // fp32 bias offsets
  long long w_off[MAX_LAYERS];  // bf16 forward-pack offsets
  long long act_last;           // K2: element offset of head_{dc-1}'s saved activations
  long long g_rgb, g_den;       // K2: element offsets of the 8-wide head cotangent rows
};

__host__ __device__ inline bool reads_x(const WideDesc& d, int i) {
  return i == 0 || ((i - 1) % d.skip == 0 && (i - 1) > 0);
}

// The number of slices the consumers take, which the schedule must match.
__host__ inline int fwd_slices(const WideDesc& d) {
  int s = 0;
  for (int i = 0; i < d.depth; ++i) s += (i > 0 ? W / 64 : 0) + (reads_x(d, i) ? d.xc : 0);
  return s + W / 64 + W / 64 + (d.dc - 1) * (WC / 64);
}
__host__ inline int bwd_slices(const WideDesc& d, bool dx) {
  int s = (d.dc - 1) * (WC / 64) + WC / 64 + W / 64;
  for (int i = d.depth - 1; i >= 0; --i) s += (i > 0 ? W / 64 : 0) + (dx && reads_x(d, i) ? 4 * d.xc : 0);
  return s;
}

// The first 1024-byte aligned address at or after p in shared memory. An
// offset added to p, not a round trip through an integer, keeps every
// pointer derived from the result known to the compiler as shared: 32-bit
// addresses and shared loads and stores rather than generic ones, which
// frees the registers whose lack made the tile kernels spill.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (hop::smem_u32(p) & 1023u)) & 1023u);
}

// ---- the producer warp and the consumers' side of the ring ----

template <int STAGES>
__device__ void produce(const Plan& plan, unsigned char* stages, uint64_t* full, uint64_t* empty) {
  for (int i = 0; i < plan.n_slices; ++i) {
    const int s = i % STAGES;
    hop::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
    const Slice sl = plan.slices[i];
    hop::mbar_expect_tx(&full[s], plan.box_bytes[sl.spec]);
    hop::tma_load(stages + s * SLICE_BYTES, &plan.maps[sl.spec], &full[s], sl.c0, sl.c1, sl.c2);
  }
}

// SB: the bytes of one stage (K3 and K4 at the object width: 16 KB).
template <int STAGES, int SB = SLICE_BYTES>
struct Ring {
  unsigned char* stages;
  uint64_t* full;
  uint64_t* empty;
  int i;
  __device__ int take() {
    const int s = i % STAGES;
    hop::mbar_wait(&full[s], (i / STAGES) & 1);
    ++i;
    return s;
  }
  __device__ void release(int s) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) hop::mbar_arrive(&empty[s]);
  }
};

template <int R>
__device__ __forceinline__ void zero(float (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
}

// K1's ping-pong: its two consumer warpgroups take turns on the tensor
// cores, one product call each, so that one's epilogue runs while the
// other's products do (named barriers 3 and 4: "warpgroup 0 / 1 may issue").
// A turn takes at most FWD_STAGES slices and is handed over once its last
// slice's products are issued, so that the other's queue right behind them;
// every slice of a turn is released without waiting on the other
// warpgroup, so the producer always finds room for the next turn's slices.
__device__ __forceinline__ void turn_begin(int wg) { hop::named_sync(3 + wg, 256); }
__device__ __forceinline__ void turn_end(int wg) { hop::named_arrive(3 + (wg ^ 1), 256); }

// acc += A[rows of this warpgroup][0 .. 64 n_slices) B over the next
// n_slices slices of the ring. A is a swizzled tile of ROWS rows whose
// 64-column block b starts at a + b * ROWS * 128; each slice holds B for
// one 64-row block of K: its N rows of 64 K-major columns, or (B_MN) its 64
// rows of N columns, MN-major, as N / 64 boxes of 64 x 64 at 8 KB steps.
// TURNS: one ping-pong turn.
template <int N, int STAGES, bool TURNS = false, bool B_MN = false, int SB = SLICE_BYTES>
__device__ void product(float (&acc)[N / 2], const unsigned char* a, int n_slices,
                        Ring<STAGES, SB>& ring, int wg) {
  hop::fence_acc(acc);
  if (TURNS) turn_begin(wg);
  int prev = -1;
  for (int s = 0; s < n_slices; ++s) {
    const int st = ring.take();
    hop::wgmma_fence();
    const uint32_t a0 = hop::smem_u32(a) + s * ROWS * 128 + wg * 64 * 128;
    const uint32_t b0 = hop::smem_u32(ring.stages + st * SB);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (B_MN)
        hop::wgmma<N, 0, 1>(acc, hop::desc_sw128(a0 + 32 * k, 16, 1024),
                            hop::desc_sw128(b0 + 2048 * k, 64 * 128, 1024), 1);
      else
        hop::wgmma<N, 0, 0>(acc, hop::desc_sw128(a0 + 32 * k, 16, 1024),
                            hop::desc_sw128(b0 + 32 * k, 16, 1024), 1);
    }
    hop::wgmma_commit();
    if (TURNS && s == n_slices - 1) turn_end(wg);
    if (prev >= 0) {
      hop::wgmma_wait<1>();
      ring.release(prev);
    }
    prev = st;
  }
  hop::wgmma_wait<0>();
  if (prev >= 0) ring.release(prev);
  hop::fence_acc(acc);
}

// Before an epilogue overwrites the warpgroup's rows of a tile: the TMA
// store of the previous contents has read them, and every thread is here.
__device__ __forceinline__ void before_overwrite(int wg, int t) {
  if (t == 0) hop::tma_store_wait_read();
  hop::named_sync(1 + wg, 128);
}
// After an epilogue: its writes are visible to TMA and wgmma, and to the
// warpgroup's other threads.
__device__ __forceinline__ void after_write(int wg) {
  hop::fence_async_smem();
  hop::named_sync(1 + wg, 128);
}
// TMA-store the warpgroup's 64 rows of `blocks` 64-column blocks of a tile
// to rows tile0 + 64 wg of plane z of `map` (one thread issues).
__device__ __forceinline__ void store_rows(const CUtensorMap* map, const unsigned char* tile,
                                           int blocks, long long tile0, int z, int wg, int t) {
  if (t != 0) return;
  for (int b = 0; b < blocks; ++b)
    hop::tma_store(map, tile + b * ROWS * 128 + wg * 64 * 128, 64 * b, (int)(tile0 + 64 * wg), z);
  hop::tma_store_commit();
}
// TMA-load the warpgroup's 64 rows of `blocks` blocks of plane z of `map`.
__device__ __forceinline__ void load_rows(const CUtensorMap* map, unsigned char* tile, int blocks,
                                          long long tile0, int z, uint64_t* bar, int wg, int t) {
  if (t != 0) return;
  hop::mbar_expect_tx(bar, blocks * 64 * 128);
  for (int b = 0; b < blocks; ++b)
    hop::tma_load(tile + b * ROWS * 128 + wg * 64 * 128, map, bar, 64 * b, (int)(tile0 + 64 * wg), z);
}

// The ray of a sample, S samples a ray, in 32-bit arithmetic: the launchers
// refuse n >= 2^31 samples (MAX_SAMPLES), and a 64-bit division is a
// subroutine call whose live registers spill.
constexpr long long MAX_SAMPLES = 1LL << 31;
__device__ __forceinline__ int ray_of(long long sample, int s_per_ray) {
  return (int)sample / s_per_ray;
}

__device__ __forceinline__ float ld_bf(const unsigned char* tile, int row, int col) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(tile + swz(ROWS, row, col)));
}

// ---- K1 ----

// tile[row, col] = bf16(act(acc + bias[col] + cond[ray(row), col])); COND:
// add the per-ray condition rows, RELU: apply relu.
template <int N, bool RELU, bool COND>
__device__ void fwd_epilogue(const float (&acc)[N / 2], unsigned char* __restrict__ tile,
                             const float* __restrict__ bias, const float* __restrict__ cond,
                             long long tile0, long long n, int s_per_ray, int wg, int t) {
  const float* crow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long sample = tile0 + 64 * wg + acc_row(t, i);
    crow[i] = cond + (long long)(sample < n ? ray_of(sample, s_per_ray) : 0) * N;
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = acc_col(t, j);
    const float2 bj = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 64 * wg + acc_row(t, i);
      float v0 = acc[4 * j + 2 * i] + bj.x;
      float v1 = acc[4 * j + 2 * i + 1] + bj.y;
      if (COND) {
        const float2 c = *reinterpret_cast<const float2*>(crow[i] + col);
        v0 += c.x;
        v1 += c.y;
      }
      if (RELU) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      *reinterpret_cast<__nv_bfloat162*>(tile + swz(ROWS, row, col)) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// A C <= 4 wide head on the CUDA cores over k columns of the tile: two
// threads per row split k and combine with a shuffle.
__device__ void small_head_wide(const unsigned char* tile, int k, const bf16* wg_, const float* bias,
                                int c_out, int wg, int t, float (&out)[4]) {
  const int row = 64 * wg + (t >> 1), half = t & 1;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kk = half * (k / 2); kk < (half + 1) * (k / 2); ++kk) {
    const float hv = ld_bf(tile, row, kk);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < c_out) s[c] = fmaf(hv, __bfloat162float(wg_[kk * c_out + c]), s[c]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    s[c] += __shfl_xor_sync(0xffffffffu, s[c], 1);
    out[c] = c < c_out ? s[c] + bias[c] : 0.f;
  }
}

// TAG names the kernel it belongs to (1: K1, 2: K2) in a profile.
template <int TAG>
__global__ void __launch_bounds__(THREADS_TILE, 1)
    wide_mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ cond,
                        const bf16* __restrict__ w, const float* __restrict__ b,
                        float* __restrict__ rgb_out, float* __restrict__ den_out, int save,
                        const __grid_constant__ Plan plan, const __grid_constant__ WideDesc d) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* act = align1024(smem_raw);
  unsigned char* xt = act + TILE_BYTES;
  unsigned char* stages = xt + d.xc * ROWS * 128;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + FWD_STAGES * SLICE_BYTES);
  uint64_t* empty = full + FWD_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < FWD_STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    hop::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256) produce<FWD_STAGES>(plan, stages, full, empty);
    return;
  }
  hop::setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const long long n = d.n, tile0 = (long long)blockIdx.x * ROWS;
  Ring<FWD_STAGES> ring{stages, full, empty, 0};

  if (wg == 1) hop::named_arrive(3, 256);  // warpgroup 0 takes the first turn
  // The input tile: feature-major fp32 -> bf16 rows, zero past in_dim and n.
  // (8 loads in flight ahead of their stores).
  for (int i0 = t; i0 < d.xc * 64 * 64; i0 += 8 * 128) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * 128, f = i >> 6, r = i & 63;
      const long long sample = tile0 + 64 * wg + r;
      v[u] = (f < d.in_dim && sample < n) ? x[(long long)f * n + sample] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * 128, f = i >> 6, r = i & 63;
      *reinterpret_cast<bf16*>(xt + swz(ROWS, 64 * wg + r, f)) = __float2bfloat16_rn(v[u]);
    }
  }
  after_write(wg);
  if (save) store_rows(&plan.maps[F_XSAVE], xt, d.xc, tile0, 0, wg, t);

  {
    float acc[W / 2];
    for (int i = 0; i < d.depth; ++i) {
      zero(acc);
      if (i > 0) product<W, FWD_STAGES, true>(acc, act, W / 64, ring, wg);
      if (reads_x(d, i)) product<W, FWD_STAGES, true>(acc, xt, d.xc, ring, wg);  // concat(h, x) @ k
      before_overwrite(wg, t);
      fwd_epilogue<W, true, false>(acc, act, b + d.b_off[i], cond, tile0, n, d.s_per_ray, wg, t);
      after_write(wg);
      if (save) store_rows(&plan.maps[F_ACT], act, W / 64, tile0, i, wg, t);
    }
    float den[4];
    small_head_wide(act, W, w + d.w_off[d.depth], b + d.b_off[d.depth], d.n_den, wg, t, den);
    const long long sample = tile0 + 64 * wg + (t >> 1);
    if ((t & 1) == 0 && sample < n)
      for (int c = 0; c < d.n_den; ++c) den_out[c * n + sample] = den[c];
    zero(acc);  // bottleneck, no activation
    product<W, FWD_STAGES, true>(acc, act, W / 64, ring, wg);
    before_overwrite(wg, t);
    fwd_epilogue<W, false, false>(acc, act, b + d.b_off[d.depth + 1], cond, tile0, n, d.s_per_ray,
                                  wg, t);
    after_write(wg);
    if (save) store_rows(&plan.maps[F_ACT], act, W / 64, tile0, d.depth, wg, t);
  }
  {
    float acc[WC / 2];
    for (int i = 0; i < d.dc; ++i) {
      zero(acc);
      product<WC, FWD_STAGES, true>(acc, act, (i == 0 ? W : WC) / 64, ring, wg);
      before_overwrite(wg, t);
      if (i == 0)
        fwd_epilogue<WC, true, true>(acc, act, b + d.b_off[d.depth + 2], cond, tile0, n,
                                     d.s_per_ray, wg, t);
      else
        fwd_epilogue<WC, true, false>(acc, act, b + d.b_off[d.depth + 2 + i], cond, tile0, n,
                                      d.s_per_ray, wg, t);
      after_write(wg);
      if (save) store_rows(&plan.maps[F_ACT_HEAD], act, WC / 64, tile0, i, wg, t);
    }
  }
  float rgb[4];
  const int l_rgb = d.depth + 2 + d.dc;
  small_head_wide(act, WC, w + d.w_off[l_rgb], b + d.b_off[l_rgb], d.n_rgb, wg, t, rgb);
  const long long sample = tile0 + 64 * wg + (t >> 1);
  if ((t & 1) == 0 && sample < n)
    for (int c = 0; c < d.n_rgb; ++c) rgb_out[c * n + sample] = rgb[c];
  if (wg == 0) hop::named_sync(3, 256);  // warpgroup 1's arrival after its last turn
  if (t == 0) hop::tma_store_wait_read();
}

// ---- K2: the tile kernel ----

// G tile[row, col] = bf16(relu'(row, col) * (acc + den_term)), MASK: relu'
// from the activation tile `mask`; DEN: den_term = sum_c gd_c w_den[col][c]
// with gd_c = bf16(h g_den[c][sample]) (n_den <= 4), h = hit[ray] with HIT
// (the object's 0/1 gate, S samples a ray), else 1. Rows at or past n
// become 0.
template <int N, bool MASK, bool DEN, bool HIT = false>
__device__ void bwd_epilogue(const float (&acc)[N / 2], unsigned char* __restrict__ gt,
                             const unsigned char* __restrict__ mask, const float* __restrict__ g_den,
                             const bf16* __restrict__ w_den, int n_den, long long tile0,
                             long long n, int wg, int t, const float* __restrict__ hit = nullptr,
                             int s_per_ray = 1) {
  bool valid[2];
  float gd[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long sample = tile0 + 64 * wg + acc_row(t, i);
    valid[i] = sample < n;
    const float h = (HIT && DEN && valid[i]) ? hit[ray_of(sample, s_per_ray)] : 1.f;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      gd[i][c] = (DEN && valid[i] && c < n_den) ? bf16_round(h * g_den[c * n + sample]) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = acc_col(t, j);
    float wd0[4], wd1[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      wd0[c] = (DEN && c < n_den) ? __bfloat162float(w_den[col * n_den + c]) : 0.f;
      wd1[c] = (DEN && c < n_den) ? __bfloat162float(w_den[(col + 1) * n_den + c]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 64 * wg + acc_row(t, i);
      float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
      if (DEN) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          v0 = fmaf(gd[i][c], wd0[c], v0);
          v1 = fmaf(gd[i][c], wd1[c], v1);
        }
      }
      if (MASK) {
        const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(mask + swz(ROWS, row, col));
        if (!(__low2float(a) > 0.f)) v0 = 0.f;
        if (!(__high2float(a) > 0.f)) v1 = 0.f;
      }
      if (!valid[i]) v0 = v1 = 0.f;
      *reinterpret_cast<__nv_bfloat162*>(gt + swz(ROWS, row, col)) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// dx[64 c + col][sample] (+)= acc for features below in_dim (fp32,
// feature-major; `first`: store, else add). Only this tile's block writes
// these samples. All loads are issued before any store, so that they do not
// wait on each other's round trips.
__device__ void dx_accumulate(const float (&acc)[32], float* dx, int c, int in_dim, long long tile0,
                              long long n, bool first, int wg, int t) {
  float old[32];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long sample = tile0 + 64 * wg + acc_row(t, i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = 64 * c + acc_col(t, j);
      const bool ok = !first && sample < n;
      old[4 * j + 2 * i] = ok && f < in_dim ? dx[f * n + sample] : 0.f;
      old[4 * j + 2 * i + 1] = ok && f + 1 < in_dim ? dx[(f + 1) * n + sample] : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long sample = tile0 + 64 * wg + acc_row(t, i);
    if (sample >= n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = 64 * c + acc_col(t, j);
      if (f < in_dim) dx[f * n + sample] = old[4 * j + 2 * i] + acc[4 * j + 2 * i];
      if (f + 1 < in_dim) dx[(f + 1) * n + sample] = old[4 * j + 2 * i + 1] + acc[4 * j + 2 * i + 1];
    }
  }
}

// The rgb head's vjp on the CUDA cores (two threads per row, half of the
// head's columns each): G tile[row][k] = bf16((act_last[sample][k] > 0) *
// sum_c gr_c w_rgb[k][c]) with gr_c = bf16(h g_rgb[c][sample]); also the
// rounded head cotangents bf16(h g) as 8-wide rows of G_rgb and G_den; h =
// hit[ray] with HIT, else 1. `scratch` (2 KB of the warpgroup's own shared
// memory) holds w_rgb as fp32 [WC][4].
template <bool HIT = false>
__device__ void rgb_head_bwd_wide(unsigned char* gt, float* scratch, const bf16* act_last,
                                  const bf16* w_rgb, int n_rgb, const float* g_rgb,
                                  const float* g_den, int n_den, bf16* g_rgb_out, bf16* g_den_out,
                                  long long tile0, long long n, int wg, int t,
                                  const float* hit = nullptr, int s_per_ray = 1) {
  for (int i = t; i < WC * 4; i += 128)
    scratch[i] = (i & 3) < n_rgb ? __bfloat162float(w_rgb[(i >> 2) * n_rgb + (i & 3)]) : 0.f;
  hop::named_sync(1 + wg, 128);
  const int row = 64 * wg + (t >> 1), half = t & 1;
  const long long sample = tile0 + row;
  const bool valid = sample < n;
  const float h = (HIT && valid) ? hit[ray_of(sample, s_per_ray)] : 1.f;
  float gr[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; valid && c < n_rgb; ++c) gr[c] = bf16_round(h * g_rgb[c * n + sample]);
  const int k0 = half * (WC / 2);
  uint4 a8s[WC / 16];  // this thread's activations, loaded ahead of the stores
#pragma unroll
  for (int kb = 0; kb < WC / 2; kb += 8)
    a8s[kb / 8] = valid ? *reinterpret_cast<const uint4*>(act_last + sample * WC + k0 + kb)
                        : make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int kb = 0; kb < WC / 2; kb += 8) {
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a8s[kb / 8]);
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const int k = k0 + kb + e;
      const float4 w0 = *reinterpret_cast<const float4*>(scratch + 4 * k);
      const float4 w1 = *reinterpret_cast<const float4*>(scratch + 4 * k + 4);
      float v0 = fmaf(gr[3], w0.w, fmaf(gr[2], w0.z, fmaf(gr[1], w0.y, fmaf(gr[0], w0.x, 0.f))));
      float v1 = fmaf(gr[3], w1.w, fmaf(gr[2], w1.z, fmaf(gr[1], w1.y, fmaf(gr[0], w1.x, 0.f))));
      if (!valid || !(__low2float(a2[e / 2]) > 0.f)) v0 = 0.f;
      if (!valid || !(__high2float(a2[e / 2]) > 0.f)) v1 = 0.f;
      *reinterpret_cast<__nv_bfloat162*>(gt + swz(ROWS, row, k)) = __floats2bfloat162_rn(v0, v1);
    }
  }
  if (valid) {
    const float* src = half == 0 ? g_rgb : g_den;
    const int nc = half == 0 ? n_rgb : n_den;
    __align__(16) bf16 r8[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) r8[c] = __float2bfloat16_rn(c < nc ? h * src[c * n + sample] : 0.f);
    *reinterpret_cast<uint4*>((half == 0 ? g_rgb_out : g_den_out) + sample * 8) =
        *reinterpret_cast<const uint4*>(r8);
  }
}

template <int TAG>
__global__ void __launch_bounds__(THREADS_TILE, 1)
    wide_mlp_bwd_kernel(const float* __restrict__ g_rgb, const float* __restrict__ g_den,
                        const bf16* __restrict__ w, const bf16* __restrict__ act,
                        bf16* __restrict__ g, float* __restrict__ dx,
                        const __grid_constant__ Plan plan, const __grid_constant__ WideDesc d) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* gt = align1024(smem_raw);
  unsigned char* mt = gt + TILE_BYTES;
  unsigned char* stages = mt + TILE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + BWD_STAGES * SLICE_BYTES);
  uint64_t* empty = full + BWD_STAGES;
  uint64_t* mbar = empty + BWD_STAGES;  // one per warpgroup: its activation rows
  if (threadIdx.x == 0) {
    for (int s = 0; s < BWD_STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    hop::mbar_init(&mbar[0], 1);
    hop::mbar_init(&mbar[1], 1);
    hop::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    hop::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256) produce<BWD_STAGES>(plan, stages, full, empty);
    return;
  }
  hop::setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const long long n = d.n, tile0 = (long long)blockIdx.x * ROWS;
  Ring<BWD_STAGES> ring{stages, full, empty, 0};
  int mphase = 0;
  auto wait_mask = [&]() {
    hop::mbar_wait(&mbar[wg], mphase);
    mphase ^= 1;
  };
  const int l_den = d.depth, l_h0 = d.depth + 2;

  rgb_head_bwd_wide(gt, reinterpret_cast<float*>(mt + wg * 64 * 128), act + d.act_last,
                    w + d.w_off[l_h0 + d.dc], d.n_rgb, g_rgb, g_den, d.n_den, g + d.g_rgb,
                    g + d.g_den, tile0, n, wg, t);
  after_write(wg);
  store_rows(&plan.maps[B_G_HEAD], gt, WC / 64, tile0, d.dc - 1, wg, t);
  {
    float acc[WC / 2];
    for (int i = d.dc - 1; i >= 1; --i) {  // head_i -> head_{i-1}
      load_rows(&plan.maps[B_ACT_HEAD], mt, WC / 64, tile0, i - 1, &mbar[wg], wg, t);
      zero(acc);
      product<WC>(acc, gt, WC / 64, ring, wg);
      wait_mask();
      before_overwrite(wg, t);
      bwd_epilogue<WC, true, false>(acc, gt, mt, g_den, w, 0, tile0, n, wg, t);
      after_write(wg);
      store_rows(&plan.maps[B_G_HEAD], gt, WC / 64, tile0, i - 1, wg, t);
    }
  }
  float acc[W / 2];
  // head_0 -> bottleneck (no activation).
  zero(acc);
  product<W>(acc, gt, WC / 64, ring, wg);
  before_overwrite(wg, t);
  bwd_epilogue<W, false, false>(acc, gt, mt, g_den, w, 0, tile0, n, wg, t);
  after_write(wg);
  store_rows(&plan.maps[B_G], gt, W / 64, tile0, d.depth, wg, t);
  // bottleneck and density head -> trunk_{depth-1}.
  load_rows(&plan.maps[B_ACT], mt, W / 64, tile0, d.depth - 1, &mbar[wg], wg, t);
  zero(acc);
  product<W>(acc, gt, W / 64, ring, wg);
  wait_mask();
  before_overwrite(wg, t);
  bwd_epilogue<W, true, true>(acc, gt, mt, g_den, w + d.w_off[l_den], d.n_den, tile0, n, wg, t);
  after_write(wg);
  store_rows(&plan.maps[B_G], gt, W / 64, tile0, d.depth - 1, wg, t);
  bool dx_first = true;  // the first x-part of the walk stores, later ones add
  for (int i = d.depth - 1; i >= 0; --i) {
    if (reads_x(d, i) && dx != nullptr) {
      for (int c = 0; c < d.xc; ++c) {
        float accx[32];
        zero(accx);
        product<64>(accx, gt, W / 64, ring, wg);
        dx_accumulate(accx, dx, c, d.in_dim, tile0, n, dx_first, wg, t);
      }
      dx_first = false;
    }
    if (i == 0) break;
    load_rows(&plan.maps[B_ACT], mt, W / 64, tile0, i - 1, &mbar[wg], wg, t);
    zero(acc);
    product<W>(acc, gt, W / 64, ring, wg);
    wait_mask();
    before_overwrite(wg, t);
    bwd_epilogue<W, true, false>(acc, gt, mt, g_den, w, 0, tile0, n, wg, t);
    after_write(wg);
    store_rows(&plan.maps[B_G], gt, W / 64, tile0, i - 1, wg, t);
  }
  if (t == 0) hop::tma_store_wait_read();
}

// ---- K2's, K4's and K6's weight gradients ----

// Job fields (ops/kernels/fused_mlp.py:dw_jobs, JOB_FIELDS): A buffer (0
// x_save, 1 act), A offset, lda, G offset, ldg, k, j, out, bias, first
// tile, row tiles, column tiles (1 here: a tile spans all j <= 256 columns).
constexpr int JF = 12;

// K4 (OBJ): the stages a block walks for object o. A 64-sample stage runs
// iff some ray it spans hits the object: its G rows were then written by
// the tile kernel (whose tile spans the same ray); a stage whose rays all
// miss would add 0 (G is zero on those rows, or never written). The block's
// threads evaluate it for all its stages at once, into shared memory.
struct DwSkip {
  const float* hit;  // the object's [n_rays] 0/1 gates
  long long n;
  int s_per_ray;
  __device__ bool runs(long long s0) const {
    const long long r1 = (s0 + DW_BK - 1 < n ? s0 + DW_BK - 1 : n - 1) / s_per_ray;
    for (long long r = s0 / s_per_ray; r <= r1; ++r)
      if (hit[r] != 0.f) return true;
    return false;
  }
};

template <int N, bool OBJ>
__device__ void dw_tile(const long long* job, int tm, int nks, float* p, unsigned char* stages,
                        uint64_t* full, uint64_t* empty, int wg, int t, const unsigned char* runs) {
  const int k = (int)job[5], j = (int)job[6];
  const long long out = job[7], bias = job[8];
  const bool rows = 128 * tm + 64 * wg < k;
  // The bias (column sums of G) rides along in the first row tile: thread
  // tid sums the 8 columns of chunk q over the stage rows r = ph (mod 8), 8
  // independent sums; the 8 row phases are added in order at the end.
  const int tid = threadIdx.x, q = tid >> 3, ph = tid & 7;
  const bool do_bias = bias >= 0 && tm == 0 && 8 * q < j;
  float acc[N / 2];
  zero(acc);
  float bsum[8];
  zero(bsum);
  hop::fence_acc(acc);
  int prev = -1;
  int ran = 0;  // stages taken (OBJ); K2 takes every stage
  for (int ks = 0; ks < nks; ++ks) {
    if (OBJ && !runs[ks]) continue;
    const int i = OBJ ? ran++ : ks;
    const int st = i % DW_STAGES;
    hop::mbar_wait(&full[st], (i / DW_STAGES) & 1);
    unsigned char* sa = stages + st * DW_STAGE;
    unsigned char* sg = sa + 2 * DW_BOX;
    if (rows) {
      hop::wgmma_fence();
      const uint32_t a0 = hop::smem_u32(sa + wg * DW_BOX), g0 = hop::smem_u32(sg);
#pragma unroll
      for (int kk = 0; kk < DW_BK / 16; ++kk)
        hop::wgmma<N, 1, 1>(acc, hop::desc_sw128(a0 + kk * 2048, DW_BOX, 1024),
                            hop::desc_sw128(g0 + kk * 2048, DW_BOX, 1024), 1);
      hop::wgmma_commit();
    }
    if (do_bias) {
      const unsigned char* chunk = sg + (q >> 3) * DW_BOX + ph * 128 + (((q & 7) ^ ph) << 4);
#pragma unroll
      for (int m = 0; m < DW_BK / 8; ++m) {
        const uint4 v = *reinterpret_cast<const uint4*>(chunk + m * 8 * 128);
        const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bsum[2 * e] += __low2float(v2[e]);
          bsum[2 * e + 1] += __high2float(v2[e]);
        }
      }
    }
    if (prev >= 0) {
      if (rows) hop::wgmma_wait<1>();
      __syncwarp();
      if ((t & 31) == 0) hop::mbar_arrive(&empty[prev]);
    }
    prev = st;
  }
  if (rows) hop::wgmma_wait<0>();
  if (prev >= 0) {
    __syncwarp();
    if ((t & 31) == 0) hop::mbar_arrive(&empty[prev]);
  }
  hop::fence_acc(acc);
  if (rows) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 128 * tm + 64 * wg + acc_row(t, i);
      if (row >= k) continue;
#pragma unroll
      for (int jj = 0; jj < N / 8; ++jj) {
        const int col = acc_col(t, jj);
        if (col < j) p[out + (long long)row * j + col] = acc[4 * jj + 2 * i];
        if (col + 1 < j) p[out + (long long)row * j + col + 1] = acc[4 * jj + 2 * i + 1];
      }
    }
  }
  if (bias >= 0 && tm == 0) {
    // Every load has landed and been consumed: stage 0 is free scratch.
    float* part8 = reinterpret_cast<float*>(stages);  // [8 row phases][256 columns]
    hop::named_sync(1, 256);
#pragma unroll
    for (int c = 0; c < 8; ++c) part8[ph * 256 + 8 * q + c] = bsum[c];
    hop::named_sync(1, 256);
    if (tid < j) {
      float b = 0.f;
      for (int r = 0; r < 8; ++r) b += part8[r * 256 + tid];
      p[bias + tid] = b;
    }
  }
}

// Block b: output tile b % n_tiles and split b / n_tiles (samples [split *
// chunk, ...)); with OBJ (K4) the jobs are one object's, and block b takes
// object (b / n_tiles) % n_obj of split b / (n_tiles n_obj): its A and G
// boxes from plane o of the maps (A from x_save: plane 0), its outputs at
// o * per_obj, and only the stages of its split that DwSkip runs (flags
// after the ring: chunk / DW_BK bytes of shared memory). Every (tile,
// object, split) writes its own partial sums.
template <int TAG, bool OBJ = false>
__global__ void __launch_bounds__(THREADS_DW, 1)
    wide_dw_kernel(const long long* __restrict__ jobs, int n_jobs, int n_tiles, long long n,
                   long long chunk, float* __restrict__ part, long long total,
                   const __grid_constant__ DwPlan plan, const float* __restrict__ hit, int n_obj,
                   long long n_rays, int s_per_ray, long long per_obj) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* stages = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + DW_STAGES * DW_STAGE);
  uint64_t* empty = full + DW_STAGES;
  unsigned char* runs = reinterpret_cast<unsigned char*>(empty + DW_STAGES);
  const int tile = blockIdx.x % n_tiles;
  const int o = OBJ ? (blockIdx.x / n_tiles) % n_obj : 0;
  const int split = OBJ ? blockIdx.x / n_tiles / n_obj : blockIdx.x / n_tiles;
  int jb = 0;
  while (jb + 1 < n_jobs && jobs[(jb + 1) * JF + 9] <= tile) ++jb;
  const long long* job = jobs + jb * JF;
  const int tm = tile - (int)job[9];
  const int k = (int)job[5], j = (int)job[6];
  const long long s_begin = (long long)split * chunk;
  const long long s_end = s_begin + chunk < n ? s_begin + chunk : n;
  const int nks = s_end > s_begin ? (int)((s_end - s_begin + DW_BK - 1) / DW_BK) : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < DW_STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    hop::mbar_init_fence();
  }
  if (OBJ) {
    const DwSkip skip{hit + o * n_rays, n, s_per_ray};
    for (int ks = threadIdx.x; ks < nks; ks += blockDim.x)
      runs[ks] = skip.runs(s_begin + (long long)ks * DW_BK);
  }
  __syncthreads();
  const int a_boxes = min(2, (k - 128 * tm + 63) / 64), g_boxes = (j + 63) / 64;
  if (threadIdx.x >= 256) {
    if (threadIdx.x != 256) return;
    const int za = job[0] == BUF_XSAVE ? 0 : o;
    int ran = 0;
    for (int ks = 0; ks < nks; ++ks) {
      if (OBJ && !runs[ks]) continue;
      const int s0 = (int)(s_begin + (long long)ks * DW_BK);
      const int i = OBJ ? ran++ : ks;
      const int st = i % DW_STAGES;
      hop::mbar_wait(&empty[st], ((i / DW_STAGES) & 1) ^ 1);
      hop::mbar_expect_tx(&full[st], (a_boxes + g_boxes) * DW_BOX);
      unsigned char* sa = stages + st * DW_STAGE;
      for (int b = 0; b < a_boxes; ++b)
        hop::tma_load(sa + b * DW_BOX, &plan.a[jb], &full[st], 128 * tm + 64 * b, s0, za);
      for (int c = 0; c < g_boxes; ++c)
        hop::tma_load(sa + (2 + c) * DW_BOX, &plan.g[jb], &full[st], 64 * c, s0, o);
    }
    return;
  }
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  float* p = part + (long long)split * total + o * per_obj;
  if (g_boxes == 1) dw_tile<64, OBJ>(job, tm, nks, p, stages, full, empty, wg, t, runs);
  else if (g_boxes == 2) dw_tile<128, OBJ>(job, tm, nks, p, stages, full, empty, wg, t, runs);
  else dw_tile<256, OBJ>(job, tm, nks, p, stages, full, empty, wg, t, runs);
}

// ---- host ----

inline size_t fwd_smem(const WideDesc& d) {
  return 1024 + TILE_BYTES + (size_t)d.xc * ROWS * 128 + FWD_STAGES * SLICE_BYTES + 2 * FWD_STAGES * 8;
}
inline size_t bwd_smem() { return 1024 + 2 * TILE_BYTES + BWD_STAGES * SLICE_BYTES + (2 * BWD_STAGES + 2) * 8; }
// `flags`: K4's per-stage flags (chunk / DW_BK bytes).
inline size_t dw_smem(size_t flags = 0) { return 1024 + DW_STAGES * DW_STAGE + 2 * DW_STAGES * 8 + flags; }

// Encode the plan's maps over the buffers by id (nullptr: that map is not
// used and stays unencoded) and copy the schedule. Returns 0 or an error.
inline int make_plan(Plan& plan, const long long* specs, int n_specs, const long long* slices,
                     int n_slices, const void* const* bases) {
  if (n_specs > MAX_MAPS || n_slices > MAX_SLICES) return -1;
  plan = Plan{};
  for (int m = 0; m < n_specs; ++m) {
    const MapSpec s{specs[9 * m + 0], specs[9 * m + 1], specs[9 * m + 2], specs[9 * m + 3],
                    specs[9 * m + 4], specs[9 * m + 5], specs[9 * m + 6], specs[9 * m + 7],
                    specs[9 * m + 8]};
    if (s.buf < 0 || s.buf > BUF_WT || s.box0 * s.box1 * 2 > SLICE_BYTES) return -1;
    plan.box_bytes[m] = (unsigned)(s.box0 * s.box1 * 2);
    const void* base = bases[s.buf];
    if (base == nullptr) continue;
    const int err = encode_map(&plan.maps[m], base, s);
    if (err != 0) return err;
  }
  for (int i = 0; i < n_slices; ++i) {
    plan.slices[i] = Slice{(int)slices[4 * i], (int)slices[4 * i + 1], (int)slices[4 * i + 2],
                           (int)slices[4 * i + 3]};
    if (plan.slices[i].spec < 0 || plan.slices[i].spec >= n_specs) return -1;
  }
  plan.n_slices = n_slices;
  return 0;
}

inline void fill_desc(WideDesc& wd, const MlpDesc& d, long long n, int s_per_ray) {
  wd = WideDesc{};
  wd.in_dim = d.in_dim;
  wd.xc = (d.in_dim + 63) / 64;
  wd.depth = d.depth;
  wd.skip = d.skip;
  wd.dc = d.depth_cond;
  wd.n_rgb = d.n_rgb;
  wd.n_den = d.n_den;
  wd.s_per_ray = s_per_ray;
  wd.n = n;
  for (int l = 0; l < d.depth + d.depth_cond + 3; ++l) {
    wd.b_off[l] = d.b_off[l];
    wd.w_off[l] = d.w_off[l];
  }
}

// The dW maps of every job: A over the rows of x_save or act, G over the
// cotangent workspace, [n][ld] bf16, boxes 64 columns x DW_BK samples; with
// n_obj > 1 (K4) act and g hold one plane per object, act_stride and
// g_stride elements apart.
inline int make_dw_plan(DwPlan& plan, const long long* jobs_host, int n_jobs, long long n,
                        const void* x_save, const void* act, const void* g, int n_obj = 1,
                        long long act_stride = 0, long long g_stride = 0) {
  if (n_jobs > MAX_JOBS) return -1;
  plan = DwPlan{};
  for (int i = 0; i < n_jobs; ++i) {
    const long long* jb = jobs_host + (long long)i * JF;
    const bool shared = jb[0] == BUF_XSAVE || n_obj == 1;
    const MapSpec a{jb[0], jb[1], jb[2], n, shared ? 1 : n_obj, jb[2],
                    shared ? jb[2] * n : act_stride, 64, DW_BK};
    const MapSpec gs{BUF_G, jb[3], jb[4], n, n_obj, jb[4], n_obj == 1 ? jb[4] * n : g_stride, 64, DW_BK};
    int err = encode_map(&plan.a[i], jb[0] == BUF_XSAVE ? x_save : act, a);
    if (err == 0) err = encode_map(&plan.g[i], g, gs);
    if (err != 0) return err;
    if (jb[11] != 1 || jb[6] > W) return -1;
  }
  return 0;
}

}  // namespace wide
}  // namespace durf
