"""durf_tpu_torch: the PyTorch / CUDA port of durf_tpu for NVIDIA Hopper.

Ported so far: the dynamic scene-graph Mip-NeRF (coordinate-major diagonal
pipeline) with proposal levels, object-ray compaction and the centering
prior; its eval render and training step, with the MLPs as hand-written
CUDA kernels (ops/kernels/, csrc/); the scene data layer (data/: the
on-disk format with a PNG codec, scene loading, host and device-resident
batching, the synthetic generator), checkpoints, metrics and the training
loop with its CLI (`python -m durf_tpu_torch.train`), and the apps a
checkpoint goes to: eval with LPIPS (`python -m durf_tpu_torch.eval`),
trajectory rendering (`.render`) and pose evaluation (`.pose_eval`).
Entry points run on the card unless the caller passes device="cpu"; on CPU
tensors the kernels' plain versions run instead.
"""
