"""PyTorch/CUDA port of scenerf_tpu: the novel-depth serve path (encode one
frame, render a pose sweep) with hand-written CUDA kernels for the pyramid
gather and the per-ray sort + composite. Imports torch and numpy, never JAX."""
