"""Hand-written CUDA kernels (csrc/) with their wrappers and plain versions:
K1 `fused_mlp.fused_nerf_mlp`, K3 `obj_mlp.fused_obj_mlp`."""
