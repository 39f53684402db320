// K6: the gated fused NeRF-MLP backward for Hopper (sm_90a).
//
// Replaces durf_tpu/ops/pallas/fused_mlp.py `fused_nerf_mlp_gated`'s
// backward (_fused_gated_bwd, fused_mlp.py:624-628 -> _fused_bwd_impl with
// gate and fill, the pallas_call at fused_mlp.py:562): the vjp of K5
// (fused_mlp_gated.cu). It is K2's backward on the blended input xe plus an
// epilogue on the blend's cotangent dxe:
//   dx = g * dxe,  dgate[s] = sum_f (x - fill)[s][f] dxe[s][f],
//   dfill = sum_s (1 - g) dxe[s][.],
// with the per-ray d cond_lin and fp32 gradients of every weight and bias.
//
// Bound on the H100: operations, twice K5's 0.33 MFLOP per sample at the
// object width (the dX and dW products).
//
// The design is K2's at 128 / 128, the mask-free build of K4's launches
// (mlp_obj.cuh, TAG 6): the persistent wgmma + TMA tile kernel walks one
// object's layers in reverse on the residuals K5 saved (the blended input
// rows and the activations), wide_dw_kernel forms the weight gradients as
// split-K products, reduce_kernel and ray_sum_kernel sum them in a fixed
// order, and feature_sum_kernel adds dfill's per-tile partials. What the
// TPU design relied on that Hopper lacks, and what this design does:
//  * The TPU kernel adds dfill into one VMEM-resident [1, F] block across its
//    sequential grid (fused_mlp.py:520-528). CUDA blocks run in parallel, so
//    the tile kernel writes each tile's partial sums of (1 - g) dxe per
//    feature (indexed by tile: a persistent block walks many), and
//    feature_sum_kernel adds them in a fixed order: the gradients are
//    bitwise reproducible, with no atomics.
//  * dgate needs the whole dxe row of a sample, which the reverse walk
//    completes only at layer 0 (the skip layer adds its share earlier). The
//    tile kernel keeps dxe in the registers that sum the x-parts' products,
//    so the gate epilogue reads it there, with the bf16 x rows from device
//    memory, before it stores dx = g dxe once.
// Only 128 / 128 is built (fused_mlp.py BWD_WIDTHS); other widths return -2.

#include "mlp_obj.cuh"

namespace durf {

template <>
int bwd_launch<6>(const BwdArgs& a, const MlpDesc& d, const BwdDesc& e, const GateArgs& ga,
                  const WideArgs& wa, cudaStream_t stream) {
  if (d.width != 128 || d.wc != 128) return -2;
  return obj::launch_narrow_bwd<6>(a, d, e, ga, wa, stream);
}

}  // namespace durf

DURF_DEFINE_BWD_ENTRY(durf_fused_nerf_mlp_gated_bwd, 6)
