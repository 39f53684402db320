// K2: the fused background NeRF-MLP backward for Hopper (sm_90a).
//
// Replaces durf_tpu/ops/pallas/fused_mlp.py `fused_nerf_mlp`'s backward
// (_fused_bwd -> _fused_bwd_impl, the pallas_call at fused_mlp.py:562): the
// vjp of K1 (fused_mlp.cu) giving dx, the per-ray d cond_lin (head_0's
// cotangent summed over the ray's samples; the view condition enters K1 per
// ray) and fp32 gradients of every weight and bias. head_0's condition rows
// get theirs from autograd through the per-ray product outside the kernel.
//
// Bound on the H100: operations. The two transposed products per layer (dX
// and dW) cost twice the forward's 1.18 MFLOP per sample at the flagship
// width, ~1.24 TFLOP at N = 4096 x 128, i.e. 1.25 ms at the bf16 peak.
//
// What the TPU design relied on that Hopper lacks, and what this design does:
//  * A sequential grid carried the weight-gradient sums: the TPU kernel
//    accumulates fp32 dW in VMEM-resident output blocks across grid steps.
//    CUDA blocks run in parallel, so the tile kernel writes each layer's
//    bf16 cotangent G_l to a device workspace, and dw_kernel forms
//    A_{l-1}^T . G_l as a split-K product over sample slices into fp32
//    partials that reduce_kernel sums in a fixed order (deterministic).
//  * The recomputed activations and vjp residuals lived in ~18 MB of VMEM;
//    an SM has 227 KB and one 128-sample tile's activations alone are
//    608 KB. K1 writes them (bf16) to device memory when called from the
//    autograd Function's forward, and this kernel reads them back for the
//    relu masks and the dW products instead of recomputing.
//  * A tile held whole rays: d cond_lin is a per-ray sum, taken here by
//    ray_sum_kernel over the head_0 cotangent rows for any samples-per-ray.
// The products themselves are mma.sync m16n8k16 on bf16 fragments with fp32
// accumulation (mlp_tile.cuh / mlp_bwd.cuh); wgmma and TMA are later work.
// Two tile-kernel instantiations of the one template: the 8x256 background
// MLP and, for the per-object route, the 8x128 object MLPs (the widths K4
// and K6 instantiate).

#include "mlp_bwd.cuh"

DURF_DEFINE_BWD_ENTRY(durf_fused_nerf_mlp_bwd, 2)
