// K4: the objects-in-grid MLP backward for Hopper (sm_90a).
//
// Replaces durf_tpu/ops/pallas/obj_mlp.py `fused_obj_mlp`'s backward
// (_obj_bwd, the pallas_call at obj_mlp.py:299): the vjp of K3
// (obj_mlp.cu), sum_o hit_o * MLP_o(x). For each object o the output
// cotangents are scaled by hit_o per ray; dx is summed over the objects,
// d cond_lin is returned per object and ray, the weight gradients are
// stacked per object, and the 0/1 hit mask gets no gradient.
//
// Bound on the H100: operations. Twice the forward's 0.33 MFLOP per sample
// per object at the flagship width (8x128, F_in 63): ~0.69 TFLOP for two
// objects at N = 4096 x 128, i.e. 0.70 ms at the bf16 peak. Every (tile,
// object) pair is computed, hit or not; skipping tiles that no ray of an
// object hits is exact and left to a later PR.
//
// What the TPU design relied on that Hopper lacks, and what this design does:
//  * The sequential grid (tiles x objects) carried stacked fp32 weight
//    gradients in VMEM across all steps. Here each object's per-layer bf16
//    cotangents go to a device workspace and the shared split-K dw_kernel
//    reduces A_{l-1}^T . G_l per object over sample slices into partials,
//    summed in a fixed order by reduce_kernel.
//  * Recomputed activations fit in VMEM; on an SM they do not. K3 saves the
//    shared input tile once and each object's bf16 activations when called
//    from the autograd Function's forward; the tile kernel reads them back.
//  * dx accumulated over the inner object axis of the grid: here one CTA
//    walks its tile's objects in order and adds each object's dx into the
//    tile's rows, which no other CTA touches.
//  * A TPU tile held whole rays, so d cond_lin was a sum inside the tile.
//    A 128-sample tile need not align with rays here; ray_sum_kernel sums
//    each object's head_0 cotangent rows per ray, for any samples-per-ray.
// Shared code: mlp_bwd.cuh (tile kernel, dW, reduction, per-ray sums).

#include "mlp_bwd.cuh"

DURF_DEFINE_BWD_ENTRY(durf_fused_obj_mlp_bwd, 4)
