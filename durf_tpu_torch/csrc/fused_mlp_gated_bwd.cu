// K6: the gated fused NeRF-MLP backward for Hopper (sm_90a).
//
// Replaces durf_tpu/ops/pallas/fused_mlp.py `fused_nerf_mlp_gated`'s
// backward (_fused_gated_bwd, fused_mlp.py:624-628 -> _fused_bwd_impl with
// gate and fill, the pallas_call at fused_mlp.py:562): the vjp of K5
// (fused_mlp_gated.cu). It is K2's backward on the blended input xe plus an
// epilogue on the blend's cotangent dxe:
//   dx = g * dxe,  dgate[s] = sum_f (x - fill)[s][f] dxe[f][s],
//   dfill = sum_s (1 - g) dxe[., s],
// with the per-ray d cond_lin and fp32 gradients of every weight and bias.
//
// Bound on the H100: operations, twice K5's 0.33 MFLOP per sample at the
// object width (the dX and dW products).
//
// What the TPU design relied on that Hopper lacks, and what this design does:
//  * The TPU kernel adds dfill into one VMEM-resident [1, F] block across its
//    sequential grid (fused_mlp.py:520-528). CUDA blocks run in parallel, so
//    each tile writes its partial sums of (1 - g) dxe per feature (warp
//    shuffles in a fixed order) and feature_sum_kernel adds the partials in
//    a fixed order: the gradients are bitwise reproducible, with no atomics.
//    The weight gradients take K2's path (split-K dW products and a
//    fixed-order reduction over the cotangents the tile kernel writes).
//  * dgate needs the whole dxe row of a sample, which the reverse walk
//    completes only at layer 0 (the skip layer adds its share earlier). The
//    tile kernel sums dxe into the fp32 dx rows it owns, then the same CTA
//    reads them back for dgate and dfill and scales them by g in place.
// Shared code: mlp_bwd.cuh (tile kernel at the 128-wide object MLP, dW,
// reduction, per-ray sums, gate epilogue).

#include "mlp_bwd.cuh"

DURF_DEFINE_BWD_ENTRY(durf_fused_nerf_mlp_gated_bwd, 6)
