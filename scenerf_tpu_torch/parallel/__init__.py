"""Multi-device execution: one process per rank under `torch.distributed`
(`dist.py`, the counterpart of `scenerf_tpu/parallel/mesh.py`) and the
ray-sharded eval renders (`sharded_render.py`)."""
