"""durf_tpu_torch: the PyTorch / CUDA port of durf_tpu for NVIDIA Hopper.

Ported so far: the eval render path of the dynamic scene-graph Mip-NeRF
(coordinate-major diagonal pipeline), with the background MLP (K1) and the
objects-in-grid MLP (K3) as hand-written CUDA kernels (ops/kernels/,
csrc/). Entry points run on the card unless the caller passes
device="cpu"; on CPU tensors the kernels' plain versions run instead.
"""
