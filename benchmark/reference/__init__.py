"""The plain reference of SceneRF that decides whether a benchmark run is
correct: the model, its renderer, losses and kernels' plain versions in
plain PyTorch, frozen copies of the program's at the time the benchmark was
written (`ops.py` holds the kernels' plain versions). It imports nothing of
the program; the benchmark hands it the same weights, frames and draws as
the program, and it works out again everything derived from them (sphere
maps, the pyramid, the samples).
"""
