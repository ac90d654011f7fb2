"""Hand-written CUDA kernels (csrc/), their build (build.py), and their
wrappers, each beside its plain PyTorch version (gather.py, composite.py,
tsdf.py; the RaySOM's in som.py)."""
