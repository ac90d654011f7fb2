"""PyTorch/CUDA port of scenerf_tpu: the novel-depth serve path (encode one
frame, render a pose sweep), the training step and the KITTI reconstruction
chain (sweep -> TSDF fusion -> occupancy metrics), with hand-written CUDA
kernels for the pyramid gather, the per-ray sort + composite, their
backwards, the RaySOM and the TSDF integrate. Imports torch and numpy, never
JAX."""
