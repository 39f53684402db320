// Building blocks of K6, the gated fused NeRF-MLP backward
// (fused_mlp_gated_bwd.cu; Hopper, sm_90a), on mma.sync; K2 and K4 take the
// reduction, the per-ray sums and the entry point's arguments.
//
// K2 runs the wgmma + TMA kernels of mlp_wide.cuh (256 / 128) and of
// mlp_obj.cuh (128 / 128) instead: mlp_bwd_launch hands it to
// hopper_bwd_launch (fused_mlp_bwd.cu), and none of the mma.sync code below
// is built for it.
//
// The backward of one MLP on N samples runs as five launches:
//  1. mlp_bwd_kernel: one CTA per 128-sample tile walks the layers in
//     reverse. The tile's cotangent G_l (bf16 [TILE_M][width] rows in shared
//     memory) is the A operand of the transposed product G_l . W_l^T (the
//     weights are packed transposed, so gemm_acc of mlp_tile.cuh runs it
//     unchanged); the epilogue masks with the saved activation (relu), rounds
//     to bf16 and writes the next G both to shared memory and to a device
//     workspace. The x-parts (layer 0, the skip layer) add into dx.
//  2. dw_kernel: every weight gradient dW_l = A_{l-1}^T . G_l is a product
//     that reduces over all N samples. Blocks own a 128x128 output tile and
//     a slice of samples and write fp32 partial sums (split-K); the bias
//     gradient (column sums of G_l) rides along in the first row tile.
//  3. reduce_kernel sums the partials of every slice in a fixed order, so
//     the gradients are deterministic.
//  4. ray_sum_kernel: d cond_lin[ray] = sum over the ray's samples of
//     head_0's cotangent (the view condition enters per ray).
//  5. feature_sum_kernel: d fill = the sum, in a fixed order, of
//     the per-tile partials the tile kernel's gate epilogue wrote.
//
// Rounding points follow the TPU kernel's backward (durf_tpu/ops/pallas/
// fused_mlp.py:58-77 with act_dtype=bf16): activations are stored in bf16,
// every cotangent is rounded to bf16 before a product, products accumulate
// in fp32, and the relu masks come from the stored activations.

#pragma once

#include "mlp_tile.cuh"

namespace durf {

// Where the backward finds its operands.
//  * wt: transposed weights, bf16. Layer l's h-part W_l[:K]^T is [J_l][K]
//    row-major at wt_off[l] (K = width, or wc for head_i with i >= 1); its
//    x-part (layer 0 and skip layers) is x_chunks matrices [J_l][64] at
//    wtx_off[l] + c * J_l * 64, zero past in_dim. -1 where a layer has none.
//  * g: cotangent workspace, bf16. G_l is [n][gw_l] at g_off[l], gw_l =
//    width (trunk, bottleneck), wc (head), 8 (density and rgb heads, zero
//    past their channels).
struct BwdDesc {
  long long wt_off[MAX_LAYERS];
  long long wtx_off[MAX_LAYERS];
  long long g_off[MAX_LAYERS];
  int x_chunks;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// gs[row, col] = bf16(relu'(row, col) * (acc + den_term)), where relu' is
// (act[sample][col] > 0) for a relu layer (act == nullptr: no relu) and
// den_term = sum_c gd_c * w_den[col][c] (w_den == nullptr: none) with gd_c
// = bf16(g_den[c][sample]). Rows at or past n become 0.
template <int NT>
__device__ void bwd_epilogue(const float (&acc)[4][NT][4], bf16* gs, int ldg, const bf16* act,
                             const float* g_den, const bf16* w_den, int n_den, long long tile0,
                             long long n) {
  constexpr int N = 32 * NT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = wm * 64 + mi * 16 + (lane >> 2) + half * 8;
      const long long sample = tile0 + row;
      const bool valid = sample < n;
      float gd[4] = {0.f, 0.f, 0.f, 0.f};
      if (valid && w_den != nullptr)
        for (int c = 0; c < n_den; ++c) gd[c] = bf16_round(g_den[c * n + sample]);
      const bf16* arow = (valid && act != nullptr) ? act + sample * N : nullptr;
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        const int col = wn * (N / 4) + nj * 8 + (lane & 3) * 2;
        float v0 = acc[mi][nj][half * 2 + 0];
        float v1 = acc[mi][nj][half * 2 + 1];
        if (w_den != nullptr) {
          for (int c = 0; c < n_den; ++c) {
            v0 = fmaf(gd[c], __bfloat162float(w_den[col * n_den + c]), v0);
            v1 = fmaf(gd[c], __bfloat162float(w_den[(col + 1) * n_den + c]), v1);
          }
        }
        if (!valid) {
          v0 = v1 = 0.f;
        } else if (arow != nullptr) {
          const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(arow + col);
          if (!(__low2float(a) > 0.f)) v0 = 0.f;
          if (!(__high2float(a) > 0.f)) v1 = 0.f;
        }
        *reinterpret_cast<__nv_bfloat162*>(gs + row * ldg + col) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// dx[col0 + col][sample] += acc[row][col] for col0 + col < in_dim (fp32,
// feature-major [in_dim][n]). Each element has one owner thread per call.
template <int NT>
__device__ void dx_accumulate(const float (&acc)[4][NT][4], float* dx, int col0, int in_dim,
                              long long tile0, long long n) {
  constexpr int N = 32 * NT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long sample = tile0 + wm * 64 + mi * 16 + (lane >> 2) + half * 8;
      if (sample >= n) continue;
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        const int f = col0 + wn * (N / 4) + nj * 8 + (lane & 3) * 2;
        if (f < in_dim) dx[f * n + sample] += acc[mi][nj][half * 2 + 0];
        if (f + 1 < in_dim) dx[(f + 1) * n + sample] += acc[mi][nj][half * 2 + 1];
      }
    }
  }
}

// K6's in-tile gate: the MLP ran on xe = bf16(g * x + (1 - g) * fill), g
// the per-ray gate, x [n][in_dim] and fill [in_dim] the bf16 input rows.
// All null for K2.
struct GateArgs {
  const bf16* x;
  const float* gate;   // [n_rays]
  const bf16* fill;
  float* dgate;        // [n] per sample
  float* dfill_part;   // [in_dim][tiles] per-tile partial sums
  float* dfill;        // [in_dim]
};

// The gate's vjp on the tile, once the reverse walk has summed the blend's
// cotangent dxe into dx (fp32 [in_dim][n]; only this CTA writes these rows):
// dgate[s] = sum_f (x[s][f] - fill[f]) dxe[f][s]; dfill_part[f][tile] =
// sum_s (1 - g) dxe[f][s] (a fixed shuffle order); then dx = g * dxe.
__device__ void gate_epilogue(const GateArgs& ga, float* dx, int in_dim, long long tile0,
                              long long n, int s_per_ray) {
  __syncthreads();  // the tile's dx rows are final and visible to the CTA
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t < TILE_M && tile0 + t < n) {
    const long long s = tile0 + t;
    const bf16* xr = ga.x + s * in_dim;
    float acc = 0.f;
    for (int f = 0; f < in_dim; ++f)
      acc = fmaf(__bfloat162float(xr[f]) - __bfloat162float(ga.fill[f]), dx[(long long)f * n + s],
                 acc);
    ga.dgate[s] = acc;
  }
  for (int f = warp; f < in_dim; f += THREADS / 32) {
    float acc = 0.f;
    for (int r = lane; r < TILE_M; r += 32) {
      const long long s = tile0 + r;
      if (s < n) acc = fmaf(1.f - ga.gate[s / s_per_ray], dx[(long long)f * n + s], acc);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) ga.dfill_part[(long long)f * gridDim.x + blockIdx.x] = acc;
  }
  __syncthreads();
  for (int i = t; i < in_dim * TILE_M; i += THREADS) {
    const int f = i / TILE_M, r = i - f * TILE_M;
    const long long s = tile0 + r;
    if (s < n) dx[(long long)f * n + s] *= ga.gate[s / s_per_ray];
  }
}

// The rgb head's vjp on the CUDA cores (two threads per row, each half of
// the head's wc columns): gs[row][k] = bf16((C_last[sample][k] > 0) *
// sum_c gr_c * w_rgb[k][c]) with gr_c = bf16(g_rgb[c][sample]). Also
// writes the rounded head cotangents as 8-wide rows of G_rgb and G_den.
__device__ void rgb_head_bwd(bf16* gs, int ldg, int wc, const bf16* act_last, const bf16* w_rgb,
                             int n_rgb, const float* g_rgb, const float* g_den, int n_den,
                             bf16* g_rgb_out, bf16* g_den_out, long long tile0, long long n) {
  const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
  const long long sample = tile0 + row;
  const bool valid = sample < n;
  float gr[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; valid && c < n_rgb; ++c) gr[c] = bf16_round(g_rgb[c * n + sample]);
  const int k0 = half * (wc / 2), k1 = k0 + wc / 2;
  for (int k = k0; k < k1; k += 2) {
    float v0 = 0.f, v1 = 0.f;
    if (valid) {
      for (int c = 0; c < n_rgb; ++c) {
        v0 = fmaf(gr[c], __bfloat162float(w_rgb[k * n_rgb + c]), v0);
        v1 = fmaf(gr[c], __bfloat162float(w_rgb[(k + 1) * n_rgb + c]), v1);
      }
      const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(act_last + sample * wc + k);
      if (!(__low2float(a) > 0.f)) v0 = 0.f;
      if (!(__high2float(a) > 0.f)) v1 = 0.f;
    }
    *reinterpret_cast<__nv_bfloat162*>(gs + row * ldg + k) = __floats2bfloat162_rn(v0, v1);
  }
  if (valid) {
    const float* src = half == 0 ? g_rgb : g_den;
    const int nc = half == 0 ? n_rgb : n_den;
    __align__(16) bf16 r8[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) r8[c] = __float2bfloat16_rn(c < nc ? src[c * n + sample] : 0.f);
    *reinterpret_cast<uint4*>((half == 0 ? g_rgb_out : g_den_out) + sample * 8) =
        *reinterpret_cast<const uint4*>(r8);
  }
}

// The MLP's backward on the tile (see the top of this file). act: the saved
// activation segments (MlpDesc::act_off); g: the cotangent workspace; dx:
// nullptr skips the x-parts.
template <int NTW, int NTC>
__device__ void run_mlp_bwd(const MlpDesc& d, const BwdDesc& e, const bf16* w, const bf16* wt,
                            const bf16* act, bf16* g, const float* g_rgb, const float* g_den,
                            float* dx, bf16* gs, bf16* ws, long long tile0, long long n) {
  constexpr int W = 32 * NTW, WC = 32 * NTC;
  const int ldg = ld_of(W > WC ? W : WC);
  const int l_den = d.depth, l_bn = d.depth + 1, l_h0 = d.depth + 2;
  const int l_rgb = l_h0 + d.depth_cond;

  rgb_head_bwd(gs, ldg, WC, act + d.act_off[d.depth + d.depth_cond], w + d.w_off[l_rgb], d.n_rgb,
               g_rgb, g_den, d.n_den, g + e.g_off[l_rgb], g + e.g_off[l_den], tile0, n);
  __syncthreads();
  store_tile(gs, ldg, WC, g + e.g_off[l_rgb - 1], tile0, n);
  {
    float acc[4][NTC][4];
    for (int i = d.depth_cond - 1; i >= 1; --i) {  // head_i -> head_{i-1}
      zero_acc(acc);
      gemm_acc<NTC>(acc, gs, ldg, WC, wt + e.wt_off[l_h0 + i], WC, ws);
      bwd_epilogue<NTC>(acc, gs, ldg, act + d.act_off[d.depth + i], nullptr, nullptr, 0, tile0, n);
      __syncthreads();
      store_tile(gs, ldg, WC, g + e.g_off[l_h0 + i - 1], tile0, n);
    }
  }
  float acc[4][NTW][4];
  // head_0 -> bottleneck (no activation).
  zero_acc(acc);
  gemm_acc<NTW>(acc, gs, ldg, WC, wt + e.wt_off[l_h0], WC, ws);
  bwd_epilogue<NTW>(acc, gs, ldg, nullptr, nullptr, nullptr, 0, tile0, n);
  __syncthreads();
  store_tile(gs, ldg, W, g + e.g_off[l_bn], tile0, n);
  // bottleneck and density head -> trunk_{depth-1}.
  zero_acc(acc);
  gemm_acc<NTW>(acc, gs, ldg, W, wt + e.wt_off[l_bn], W, ws);
  bwd_epilogue<NTW>(acc, gs, ldg, act + d.act_off[d.depth - 1], g_den, w + d.w_off[l_den],
                    d.n_den, tile0, n);
  __syncthreads();
  store_tile(gs, ldg, W, g + e.g_off[d.depth - 1], tile0, n);
  for (int i = d.depth - 1; i >= 0; --i) {
    const bool reads_x = i == 0 || ((i - 1) % d.skip == 0 && (i - 1) > 0);
    if (reads_x && dx != nullptr) {
      for (int c = 0; c < e.x_chunks; ++c) {
        float accx[4][2][4];
        zero_acc(accx);
        gemm_acc<2>(accx, gs, ldg, W, wt + e.wtx_off[i] + (long long)c * W * 64, W, ws);
        dx_accumulate<2>(accx, dx, c * 64, d.in_dim, tile0, n);
      }
    }
    if (i == 0) break;
    zero_acc(acc);
    gemm_acc<NTW>(acc, gs, ldg, W, wt + e.wt_off[i], W, ws);
    bwd_epilogue<NTW>(acc, gs, ldg, act + d.act_off[i - 1], nullptr, nullptr, 0, tile0, n);
    __syncthreads();
    store_tile(gs, ldg, W, g + e.g_off[i - 1], tile0, n);
  }
}

__host__ inline size_t bwd_smem_bytes(const MlpDesc& d) {
  const int hmax = d.width > d.wc ? d.width : d.wc;
  return ((size_t)TILE_M * ld_of(hmax) + (size_t)STAGES * BK * ld_of(hmax)) * sizeof(bf16);
}

// TAG (6: K6) names the launch in a profile (profile.py).
template <int TAG, int NTW, int NTC>
__global__ void __launch_bounds__(THREADS)
    mlp_bwd_kernel(const float* __restrict__ g_rgb, const float* __restrict__ g_den,
                   const bf16* __restrict__ w, const bf16* __restrict__ wt,
                   const bf16* __restrict__ act, bf16* __restrict__ g, float* __restrict__ dx,
                   long long n, int s_per_ray, MlpDesc d, BwdDesc e, GateArgs ga) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hmax = d.width > d.wc ? d.width : d.wc;
  bf16* gs = reinterpret_cast<bf16*>(smem);
  bf16* ws = gs + TILE_M * ld_of(hmax);
  const long long tile0 = (long long)blockIdx.x * TILE_M;
  run_mlp_bwd<NTW, NTC>(d, e, w, wt, act, g, g_rgb, g_den, dx, gs, ws, tile0, n);
  gate_epilogue(ga, dx, d.in_dim, tile0, n, s_per_ray);
}

// ---- weight gradients: split-K products over the sample axis ----

constexpr int DW_TILE = 128;          // output rows (features of A) and columns (of G)
constexpr int DW_BK = 32;             // samples per pipeline stage
constexpr int DW_LD = DW_TILE + PAD;  // shared row stride (bf16)
constexpr int JOB_FIELDS = 12;

// One product dW[k][j] = sum_s A[s][k] G[s][j] (+ bias[j] = sum_s G[s][j]),
// as int64 fields (ops/kernels/fused_mlp.py:dw_jobs): A buffer (0 x_save,
// 1 act), A offset, lda, G offset (in g), ldg (elements from the buffers'
// bases), k, j, out (offset of dW[0][0] in the flat output, row stride j),
// bias (offset of bias[0], or -1), first output tile, row tiles, column
// tiles. A and G are bf16 [n][ld] row-major with zeros in columns
// [k, round8(k)) / [j, round8(j)).
__device__ __forceinline__ void dw_load_stage(bf16* dst, const bf16* src, long long ld, int cols,
                                              int c0, long long s0, long long s_end) {
  for (int c = threadIdx.x; c < DW_BK * (DW_TILE / 8); c += THREADS) {
    const int r = c / (DW_TILE / 8), cc = c - r * (DW_TILE / 8);
    const long long s = s0 + r;
    const int col = c0 + cc * 8;
    const bool ok = s < s_end && col < cols;
    cp_async16(dst + r * DW_LD + cc * 8, ok ? src + s * ld + col : src, ok ? 16 : 0);
  }
}

template <int TAG>
__global__ void __launch_bounds__(THREADS)
    dw_kernel(const long long* __restrict__ jobs, int n_jobs, long long n, long long chunk,
              float* __restrict__ part, long long total, const bf16* __restrict__ x_save,
              const bf16* __restrict__ act, const bf16* __restrict__ gbuf) {
  constexpr int STAGE = DW_BK * DW_LD;
  __shared__ __align__(16) unsigned char smem_raw[4 * STAGE * sizeof(bf16)];
  bf16* const as[2] = {reinterpret_cast<bf16*>(smem_raw),
                       reinterpret_cast<bf16*>(smem_raw) + STAGE};
  bf16* const gsm[2] = {reinterpret_cast<bf16*>(smem_raw) + 2 * STAGE,
                        reinterpret_cast<bf16*>(smem_raw) + 3 * STAGE};
  const int tile = blockIdx.x;
  int jb = 0;
  while (jb + 1 < n_jobs && jobs[(jb + 1) * JOB_FIELDS + 9] <= tile) ++jb;
  const long long* job = jobs + jb * JOB_FIELDS;
  const bf16* A = (job[0] == 0 ? x_save : act) + job[1];
  const bf16* G = gbuf + job[3];
  const long long lda = job[2], ldg = job[4];
  const int k = (int)job[5], j = (int)job[6];
  const long long out = job[7], bias = job[8];
  const int local = tile - (int)job[9];
  const int tm = local / (int)job[11], tn = local - tm * (int)job[11];
  const int m0 = tm * DW_TILE, n0 = tn * DW_TILE;
  const int kv = (k + 7) / 8 * 8, jv = (j + 7) / 8 * 8;
  const long long s_begin = (long long)blockIdx.y * chunk;
  const long long s_end = s_begin + chunk < n ? s_begin + chunk : n;
  const int nks = s_end > s_begin ? (int)((s_end - s_begin + DW_BK - 1) / DW_BK) : 0;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;  // warp tile: 64 rows x 32 columns
  const bool do_bias = bias >= 0 && tm == 0 && threadIdx.x < DW_TILE;
  float acc[4][4][4];
  zero_acc(acc);
  float bsum = 0.f;

  if (nks > 0) {
    dw_load_stage(as[0], A, lda, kv, m0, s_begin, s_end);
    dw_load_stage(gsm[0], G, ldg, jv, n0, s_begin, s_end);
  }
  cp_async_commit();
  for (int kt = 0; kt < nks; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nks) {
      const long long s0 = s_begin + (long long)(kt + 1) * DW_BK;
      dw_load_stage(as[cur ^ 1], A, lda, kv, m0, s0, s_end);
      dw_load_stage(gsm[cur ^ 1], G, ldg, jv, n0, s0, s_end);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* a_s = as[cur];
    const bf16* g_s = gsm[cur];
#pragma unroll
    for (int kk = 0; kk < DW_BK; kk += 16) {
      // A^T fragments from sample-major rows: ldmatrix.trans of [k][m] 8x8
      // blocks gives the row-major m16k16 operand.
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4_t(a[mi], a_s + (kk + ((lane >> 4) & 1) * 8 + (lane & 7)) * DW_LD + wm * 64 +
                             mi * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t b[4];
        ldsm_x4_t(b, g_s + (kk + (lane & 15)) * DW_LD + wn * 32 + nj * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
    if (do_bias) {
#pragma unroll 8
      for (int r = 0; r < DW_BK; ++r) bsum += __bfloat162float(g_s[r * DW_LD + threadIdx.x]);
    }
    __syncthreads();
  }

  float* p = part + (long long)blockIdx.y * total;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mi * 16 + (lane >> 2) + half * 8;
      if (row >= k) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + (lane & 3) * 2;
        if (col < j) p[out + (long long)row * j + col] = acc[mi][nt][half * 2 + 0];
        if (col + 1 < j) p[out + (long long)row * j + col + 1] = acc[mi][nt][half * 2 + 1];
      }
    }
  }
  if (do_bias && n0 + (int)threadIdx.x < j) p[bias + n0 + threadIdx.x] = bsum;
}

// out[i] = sum over slices s of part[s][i], in slice order.
template <int TAG>
__global__ void reduce_kernel(const float* __restrict__ part, int n_splits, long long total,
                              float* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < n_splits; ++k) s += part[(long long)k * total + i];
    out[i] = s;
  }
}

// dcond[o][r][c] = sum over the ray's samples of G_head0[o][r * S + s][c]
// (fp32). One block per (ray, object), one thread per column. With `hit`
// ([n_obj][n_rays], K4), a ray that misses the object gets 0: K4 skips the
// pairs no ray of a tile hits, so its G rows may never have been written.
template <int TAG>
__global__ void ray_sum_kernel(const bf16* __restrict__ g, long long g_obj_stride,
                               long long g_off, int wc, int s_per_ray, long long n_rays,
                               float* __restrict__ dcond, const float* __restrict__ hit = nullptr) {
  const long long r = blockIdx.x;
  const int o = blockIdx.y, c = threadIdx.x;
  const bf16* src = g + o * g_obj_stride + g_off + r * s_per_ray * wc + c;
  float s = 0.f;
  if (hit == nullptr || hit[o * n_rays + r] != 0.f)
    for (int i = 0; i < s_per_ray; ++i) s += __bfloat162float(src[(long long)i * wc]);
  dcond[((long long)o * n_rays + r) * wc + c] = s;
}

// out[f] = sum over tiles of part[f][tile]: one block per feature, each
// thread a fixed strided subset, then a fixed shared-memory tree.
template <int TAG>
__global__ void __launch_bounds__(THREADS)
    feature_sum_kernel(const float* __restrict__ part, int tiles, float* __restrict__ out) {
  __shared__ float red[THREADS];
  const float* row = part + (long long)blockIdx.x * tiles;
  float s = 0.f;
  for (int t = threadIdx.x; t < tiles; t += THREADS) s += row[t];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = THREADS / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = red[0];
}

// Arguments shared by the K2 and K6 entry points (see
// DURF_DEFINE_BWD_ENTRY): the launches of one MLP backward on `stream`.
struct BwdArgs {
  const float* g_rgb;
  const float* g_den;
  long long n_rays;
  const bf16* w;     // forward pack (density and rgb heads read from it)
  const bf16* wt;    // transposed pack
  const bf16* act;   // saved activations
  const bf16* x_save;  // saved input rows
  bf16* g;           // cotangent workspace
  float* dx;         // [in_dim][n] accumulated (zeroed by the caller), or nullptr
  float* dcond;      // [n_rays][wc]
  const long long* jobs;       // the dW job table on the device
  const long long* jobs_host;  // the same in host memory (K2's wide path builds its maps from it)
  int n_jobs, n_tiles, n_splits;
  long long chunk;
  float* part;       // [n_splits][total]
  float* dw;         // [total]
  long long total;
  long long n;
  int s_per_ray;
};

template <int TAG, int NTW, int NTC>
static int launch_bwd_tiles(const BwdArgs& a, const MlpDesc& d, const BwdDesc& e,
                            const GateArgs& ga, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(d);
  auto kern = mlp_bwd_kernel<TAG, NTW, NTC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (a.n + TILE_M - 1) / TILE_M;
  kern<<<(unsigned)grid, THREADS, smem, stream>>>(a.g_rgb, a.g_den, a.w, a.wt, a.act, a.g, a.dx,
                                                  a.n, a.s_per_ray, d, e, ga);
  return (int)cudaGetLastError();
}

template <int TAG>
int launch_reduce(const BwdArgs& a, cudaStream_t stream) {
  long long blocks = (a.total + THREADS - 1) / THREADS;
  if (blocks > 4096) blocks = 4096;
  reduce_kernel<TAG><<<(unsigned)blocks, THREADS, 0, stream>>>(a.part, a.n_splits, a.total, a.dw);
  return (int)cudaGetLastError();
}

template <int TAG>
int launch_ray_sum(const BwdArgs& a, const MlpDesc& d, const BwdDesc& e, cudaStream_t stream) {
  ray_sum_kernel<TAG><<<(unsigned)a.n_rays, d.wc, 0, stream>>>(
      a.g, 0, e.g_off[d.depth + 2], d.wc, a.s_per_ray, a.n_rays, a.dcond);
  return (int)cudaGetLastError();
}

// The producer's schedule (specs, slices) of the wgmma + TMA tile kernels,
// as the Python side built it.
struct WideArgs {
  const long long* specs;
  int n_specs;
  const long long* slices;
  int n_slices;
};
// K2's launches: fused_mlp_bwd.cu specialises this for TAG 2.
template <int TAG>
int hopper_bwd_launch(const BwdArgs&, const MlpDesc&, const BwdDesc&, const WideArgs&, cudaStream_t);

// K2 (TAG 2) goes to hopper_bwd_launch; K6 (TAG 6) runs the mma.sync
// launches above at the object MLPs' widths (fused_mlp.BWD_WIDTHS), other
// widths return -2.
template <int TAG>
int mlp_bwd_launch(const BwdArgs& a, const MlpDesc& d, const BwdDesc& e, const GateArgs& ga,
                   const WideArgs& wa, cudaStream_t stream) {
  if ((ga.gate != nullptr) != (TAG == 6) || (TAG == 6 && a.dx == nullptr)) return -1;
  if constexpr (TAG == 2) {
    return hopper_bwd_launch<TAG>(a, d, e, wa, stream);
  } else {
    if (d.width != 128 || d.wc != 128) return -2;
    int err = launch_bwd_tiles<TAG, 4, 4>(a, d, e, ga, stream);
    if (err != 0) return err;
    dw_kernel<TAG><<<dim3((unsigned)a.n_tiles, (unsigned)a.n_splits), THREADS, 0, stream>>>(
        a.jobs, a.n_jobs, a.n, a.chunk, a.part, a.total, a.x_save, a.act, a.g);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    if ((err = launch_reduce<TAG>(a, stream)) != 0) return err;
    if ((err = launch_ray_sum<TAG>(a, d, e, stream)) != 0) return err;
    const int tiles = (int)((a.n + TILE_M - 1) / TILE_M);
    feature_sum_kernel<TAG><<<(unsigned)d.in_dim, THREADS, 0, stream>>>(ga.dfill_part, tiles, ga.dfill);
    return (int)cudaGetLastError();
  }
}

// Descriptors from the flat arrays the Python wrappers pass.
inline int make_bwd_descs(MlpDesc& d, BwdDesc& e, int in_dim, int width, int depth, int skip,
                          int wc, int depth_cond, int n_rgb, int n_den, const long long* w_off,
                          const long long* act_off, const long long* wt_off,
                          const long long* wtx_off, const long long* g_off, int n_layers) {
  if (n_layers > MAX_LAYERS || n_layers != depth + depth_cond + 3) return -1;
  d = MlpDesc{};
  e = BwdDesc{};
  d.in_dim = in_dim;
  d.in_pad = (in_dim + BK - 1) / BK * BK;
  d.width = width;
  d.depth = depth;
  d.skip = skip;
  d.wc = wc;
  d.depth_cond = depth_cond;
  d.n_rgb = n_rgb;
  d.n_den = n_den;
  for (int l = 0; l < n_layers; ++l) {
    d.w_off[l] = w_off[l];
    e.wt_off[l] = wt_off[l];
    e.wtx_off[l] = wtx_off[l];
    e.g_off[l] = g_off[l];
  }
  for (int a = 0; a < depth + 1 + depth_cond; ++a) d.act_off[a] = act_off[a];
  e.x_chunks = (in_dim + 63) / 64;
  return 0;
}

}  // namespace durf

// The C entry point NAME of K2 (TAG 2) and K6 (TAG 6); each .cu expands it
// once. The gate pointers (gx .. dfill) are null except for K6.
#define DURF_DEFINE_BWD_ENTRY(NAME, TAG)                                                         \
  extern "C" int NAME(                                                                           \
      const float* g_rgb, const float* g_den, long long n_rays, const void* w, const void* wt,   \
      const void* act, const void* x_save, void* g, float* dx, float* dcond,                     \
      const long long* jobs, const long long* jobs_host, int n_jobs, int n_tiles, int n_splits,  \
      long long chunk, float* part, float* dw,                                                   \
      long long total, long long n, int s_per_ray, int in_dim, int width, int depth,             \
      int skip, int wc, int depth_cond, int n_rgb, int n_den, const long long* w_off,            \
      const long long* act_off, const long long* wt_off, const long long* wtx_off,               \
      const long long* g_off, int n_layers, const void* gx, const float* gate,                   \
      const void* gfill, float* dgate, float* dfill_part, float* dfill, const long long* specs,  \
      int n_specs, const long long* slices, int n_slices, void* stream) {                        \
    durf::MlpDesc d;                                                                             \
    durf::BwdDesc e;                                                                             \
    int err = durf::make_bwd_descs(d, e, in_dim, width, depth, skip, wc, depth_cond, n_rgb,      \
                                   n_den, w_off, act_off, wt_off, wtx_off, g_off, n_layers);     \
    if (err != 0) return err;                                                                    \
    durf::BwdArgs a{g_rgb,                                                                       \
                    g_den,                                                                       \
                    n_rays,                                                                      \
                    static_cast<const durf::bf16*>(w),                                           \
                    static_cast<const durf::bf16*>(wt),                                          \
                    static_cast<const durf::bf16*>(act),                                         \
                    static_cast<const durf::bf16*>(x_save),                                      \
                    static_cast<durf::bf16*>(g),                                                 \
                    dx,                                                                          \
                    dcond,                                                                       \
                    jobs,                                                                        \
                    jobs_host,                                                                   \
                    n_jobs,                                                                      \
                    n_tiles,                                                                     \
                    n_splits,                                                                    \
                    chunk,                                                                       \
                    part,                                                                        \
                    dw,                                                                          \
                    total,                                                                       \
                    n,                                                                           \
                    s_per_ray};                                                                  \
    durf::GateArgs ga{static_cast<const durf::bf16*>(gx), gate,                                  \
                      static_cast<const durf::bf16*>(gfill), dgate, dfill_part, dfill};          \
    durf::WideArgs wa{specs, n_specs, slices, n_slices};                                         \
    return durf::mlp_bwd_launch<TAG>(a, d, e, ga, wa, static_cast<cudaStream_t>(stream));        \
  }
