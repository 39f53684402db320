// Building blocks of the fused NeRF-MLP forward kernels (Hopper, sm_90a).
//
// One CTA runs a whole MLP on a tile of TILE_M = 128 samples. The tile's
// activations live in shared memory as bf16 [TILE_M][width] rows (the A
// operand of every layer); each layer's weights, [K][N] row-major bf16 as
// flax stores them, stream through shared memory in BK-row slices with a
// two-stage cp.async ring. The products run on the tensor cores through
// mma.sync m16n8k16 (bf16 operands, fp32 accumulators); the epilogue adds
// the fp32 bias (and, for head_0, the per-ray condition rows), applies relu
// in fp32 and rounds to bf16 for the next layer: every consumer of an
// activation reads it in bf16, as in the JAX package's `_forward_tile`.
// The 1- and 3-wide heads run on the CUDA cores (fp32 sums of bf16
// operands).
//
// Warp layout: 8 warps as 2 (rows) x 4 (columns); a warp owns 64 rows and
// N/4 columns of a layer's output, i.e. 4 x NT m16n8 accumulator tiles with
// NT = N / 32. Widths 128 and 256 are instantiated, for the width pairs
// the wgmma + TMA kernels do not take (those of mlp_wide.cuh run K1 at 256 /
// 128; those of mlp_obj.cuh K1, K3 and K5 at 128 / 128).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace durf {

typedef __nv_bfloat16 bf16;

constexpr int TILE_M = 128;   // samples per CTA
constexpr int THREADS = 256;  // 8 warps
constexpr int BK = 32;        // weight rows per pipeline stage
constexpr int STAGES = 2;     // weight slices in flight (cp.async ring)
constexpr int PAD = 8;        // bf16 row padding (16 B): conflict-free ldmatrix
constexpr int MAX_LAYERS = 24;

// Packed weights: layer l of object o starts at w + o * w_obj_stride +
// w_off[l] (bf16, [K][N] row-major) and its bias at b + o * b_obj_stride +
// b_off[l] (fp32). Layer order: trunk_0..trunk_{depth-1}, density_head,
// bottleneck, head_0 (its first `width` rows only: the condition rows are
// applied outside as per-ray rows), head_1.., rgb_head.
struct MlpDesc {
  int in_dim;      // F, features per sample
  int in_pad;      // F rounded up to BK (zero columns / zero weight rows)
  int width;       // trunk width W
  int depth;       // trunk layers
  int skip;        // skip_layer: layer i re-reads x when (i-1) % skip == 0, i > 1
  int wc;          // head width
  int depth_cond;  // head layers (>= 1)
  int n_rgb;       // rgb channels (<= 4)
  int n_den;       // density channels (<= 4)
  long long w_obj_stride;
  long long b_obj_stride;
  long long w_off[MAX_LAYERS];
  long long b_off[MAX_LAYERS];
  // Saved activations for the backward (used only when a save pointer is
  // given): segment a of object o is a [n][width] bf16 row-major buffer at
  // act + o * act_obj_stride + act_off[a]; segments are trunk_0..
  // trunk_{depth-1} (width), bottleneck (width), head_0.. (wc).
  long long act_obj_stride;
  long long act_off[MAX_LAYERS];
};

__host__ __device__ inline int ld_of(int k) { return k + PAD; }

// Dynamic shared memory: x tile, activation tile, STAGES weight slices.
__host__ inline size_t smem_bytes(const MlpDesc& d) {
  int hmax = d.width > d.wc ? d.width : d.wc;
  size_t xs = (size_t)TILE_M * ld_of(d.in_pad);
  size_t hs = (size_t)TILE_M * ld_of(hmax);
  size_t ws = (size_t)STAGES * BK * ld_of(hmax);
  return (xs + hs + ws) * sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy weight rows [k0, k0 + BK) of a [k_valid][n] matrix into one stage;
// rows at or past k_valid are zero-filled (they meet zero-padded x columns).
__device__ __forceinline__ void load_w_stage(bf16* stage, const bf16* wg, int k0, int k_valid,
                                             int n) {
  const int chunks_per_row = n / 8;
  const int total = BK * chunks_per_row;
  const int ldw = ld_of(n);
  for (int c = threadIdx.x; c < total; c += THREADS) {
    int r = c / chunks_per_row, cc = c - r * chunks_per_row;
    int k = k0 + r;
    const bf16* src = k < k_valid ? wg + (size_t)k * n + cc * 8 : wg;
    cp_async16(stage + r * ldw + cc * 8, src, k < k_valid ? 16 : 0);
  }
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[4][NT][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
}

// acc += A[:, 0:k_pad] @ Wg[0:k_valid, 0:N] for the CTA's TILE_M rows;
// N = 32 * NT. Ends with a barrier, so the caller may overwrite A.
template <int NT>
__device__ void gemm_acc(float (&acc)[4][NT][4], const bf16* as, int lda, int k_pad,
                         const bf16* wg, int k_valid, bf16* ws) {
  constexpr int N = 32 * NT;
  const int ldw = ld_of(N);
  const int stage = BK * ldw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int nk = k_pad / BK;

  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load_w_stage(ws + st * stage, wg, st * BK, k_valid, N);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    // Slice kt + STAGES - 1 goes into the slot that slice kt - 1 used; the
    // barrier closing iteration kt - 1 has released it.
    const int pf = kt + STAGES - 1;
    if (pf < nk) load_w_stage(ws + (pf % STAGES) * stage, wg, pf * BK, k_valid, N);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // slice kt has landed
    __syncthreads();
    const bf16* bs = ws + (kt % STAGES) * stage;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(a[mi], as + (wm * 64 + mi * 16 + (lane & 15)) * lda + kt * BK + kk +
                           (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < NT / 2; ++nj) {
        uint32_t b[4];
        ldsm_x4_t(b, bs + (kk + (lane & 15)) * ldw + wn * (N / 4) + nj * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }
}

// hs[row, col] = bf16(act(acc + bias[col] + cond[ray(row), col])).
// cond (optional) holds per-ray fp32 rows [n_rays][N]; ray = (tile0+row)/S.
template <int NT>
__device__ void epilogue(const float (&acc)[4][NT][4], bf16* hs, int ldh, const float* bias,
                         const float* cond, long long tile0, long long n, int s_per_ray,
                         bool relu) {
  constexpr int N = 32 * NT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = wm * 64 + mi * 16 + (lane >> 2) + half * 8;
      const long long sample = tile0 + row;
      const float* crow =
          (cond != nullptr && sample < n) ? cond + (sample / s_per_ray) * (long long)N : nullptr;
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        const int col = wn * (N / 4) + nj * 8 + (lane & 3) * 2;
        float v0 = acc[mi][nj][half * 2 + 0] + bias[col];
        float v1 = acc[mi][nj][half * 2 + 1] + bias[col + 1];
        if (crow != nullptr) {
          v0 += crow[col];
          v1 += crow[col + 1];
        }
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(hs + row * ldh + col) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// A C <= 4 wide head on the CUDA cores: two threads per row split K and
// combine with a shuffle; both threads of the pair return the row's sums.
__device__ __forceinline__ void small_head(const bf16* hs, int ldh, int k, const bf16* wg,
                                           const float* bias, int c_out, float (&out)[4]) {
  const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  const int k0 = half * (k / 2), k1 = k0 + k / 2;
  for (int kk = k0; kk < k1; ++kk) {
    const float hv = __bfloat162float(hs[row * ldh + kk]);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < c_out) s[c] = fmaf(hv, __bfloat162float(wg[kk * c_out + c]), s[c]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    s[c] += __shfl_xor_sync(0xffffffffu, s[c], 1);
    out[c] = c < c_out ? s[c] + bias[c] : 0.f;
  }
}

// Feature-major fp32 x [F][n] -> bf16 rows xs[TILE_M][in_pad], zero past F
// and past the last sample.
__device__ void load_x_tile(bf16* xs, const float* x, const MlpDesc& d, long long tile0,
                            long long n) {
  const int ldx = ld_of(d.in_pad);
  for (int i = threadIdx.x; i < d.in_pad * TILE_M; i += THREADS) {
    const int f = i / TILE_M, r = i - f * TILE_M;
    float v = 0.f;
    if (f < d.in_dim && tile0 + r < n) v = x[(long long)f * n + tile0 + r];
    xs[r * ldx + f] = __float2bfloat16_rn(v);
  }
  __syncthreads();
}

// The forward kernels' descriptor from the flat arrays the Python wrappers
// pass (K1, K5; K3 adds its object strides). Returns 0, or -1 when the layer
// or activation-segment counts do not fit.
__host__ inline int make_fwd_desc(MlpDesc& d, int in_dim, int width, int depth, int skip, int wc,
                                  int depth_cond, int n_rgb, int n_den, const long long* w_off,
                                  const long long* b_off, int n_layers, bool save,
                                  const long long* act_off, int n_act) {
  if (n_layers > MAX_LAYERS || n_layers != depth + depth_cond + 3) return -1;
  d = MlpDesc{};
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
    d.b_off[l] = b_off[l];
  }
  if (save && n_act != depth + 1 + depth_cond) return -1;
  for (int a = 0; save && a < n_act; ++a) d.act_off[a] = act_off[a];
  return 0;
}

// Copy the tile's bf16 rows s[0:TILE_M][0:cols] (row stride lds) to rows
// [tile0, tile0 + TILE_M) of a [n][cols] row-major buffer in 16-byte chunks,
// skipping rows at or past n. cols is a multiple of 8.
__device__ __forceinline__ void store_tile(const bf16* s, int lds, int cols, bf16* dst,
                                           long long tile0, long long n) {
  const int chunks = cols / 8;
  for (int c = threadIdx.x; c < TILE_M * chunks; c += THREADS) {
    const int r = c / chunks, cc = c - r * chunks;
    if (tile0 + r < n)
      *reinterpret_cast<uint4*>(dst + (tile0 + r) * cols + cc * 8) =
          *reinterpret_cast<const uint4*>(s + r * lds + cc * 8);
  }
}

// One object's MLP on the tile: trunk, density head, bottleneck, condition
// head(s), rgb head. Returns this thread's row sums in rgb[] / den[] (row =
// threadIdx.x / 2). `cond` holds the per-ray head_0 condition rows [n_rays][wc].
// With `save` (this object's activation segments, see MlpDesc) every stored
// activation tile is also written to device memory for the backward.
template <int NTW, int NTC>
__device__ void run_mlp(const MlpDesc& d, const bf16* w, const float* b, const float* cond,
                        const bf16* xs, bf16* hs, bf16* ws, long long tile0, long long n,
                        int s_per_ray, float (&rgb)[4], float (&den)[4], bf16* save = nullptr) {
  constexpr int W = 32 * NTW;
  const int ldx = ld_of(d.in_pad);
  const int hmax = d.width > d.wc ? d.width : d.wc;
  const int ldh = ld_of(hmax);
  {
    float acc[4][NTW][4];
    for (int i = 0; i < d.depth; ++i) {
      const bf16* wl = w + d.w_off[i];
      zero_acc(acc);
      if (i == 0) {
        gemm_acc<NTW>(acc, xs, ldx, d.in_pad, wl, d.in_dim, ws);
      } else if ((i - 1) % d.skip == 0 && (i - 1) > 0) {
        // concat(h, x) @ k == h @ k[:W] + x @ k[W:]
        gemm_acc<NTW>(acc, hs, ldh, W, wl, W, ws);
        gemm_acc<NTW>(acc, xs, ldx, d.in_pad, wl + (size_t)W * W, d.in_dim, ws);
      } else {
        gemm_acc<NTW>(acc, hs, ldh, W, wl, W, ws);
      }
      epilogue<NTW>(acc, hs, ldh, b + d.b_off[i], nullptr, tile0, n, s_per_ray, true);
      __syncthreads();
      if (save != nullptr) store_tile(hs, ldh, W, save + d.act_off[i], tile0, n);
    }
    small_head(hs, ldh, W, w + d.w_off[d.depth], b + d.b_off[d.depth], d.n_den, den);
    // bottleneck (no activation); gemm_acc's closing barrier also orders
    // the density head's and the save's reads of hs before the overwrite.
    zero_acc(acc);
    gemm_acc<NTW>(acc, hs, ldh, W, w + d.w_off[d.depth + 1], W, ws);
    epilogue<NTW>(acc, hs, ldh, b + d.b_off[d.depth + 1], nullptr, tile0, n, s_per_ray, false);
    __syncthreads();
    if (save != nullptr) store_tile(hs, ldh, W, save + d.act_off[d.depth], tile0, n);
  }
  {
    constexpr int WC = 32 * NTC;
    float acc[4][NTC][4];
    for (int i = 0; i < d.depth_cond; ++i) {
      const int l = d.depth + 2 + i;
      zero_acc(acc);
      gemm_acc<NTC>(acc, hs, ldh, i == 0 ? W : WC, w + d.w_off[l], i == 0 ? W : WC, ws);
      epilogue<NTC>(acc, hs, ldh, b + d.b_off[l], i == 0 ? cond : nullptr, tile0, n, s_per_ray,
                    true);
      __syncthreads();
      if (save != nullptr) store_tile(hs, ldh, WC, save + d.act_off[d.depth + 1 + i], tile0, n);
    }
    const int l = d.depth + 2 + d.depth_cond;
    small_head(hs, ldh, WC, w + d.w_off[l], b + d.b_off[l], d.n_rgb, rgb);
  }
}

}  // namespace durf
