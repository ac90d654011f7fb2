"""Record the RaySOM inputs of one training-render chunk at the KITTI preset
on one NVIDIA GPU, with the EM's outputs on them, for the CPU test that
holds the port's RaySOM to the JAX package's on real render inputs
(tests/test_torch_train_ops.py).

    python3 scripts/som_chunk_torch.py [--out tests/_torch_som_kitti_chunk.npz]

Builds SceneRF(kitti()) with seeded random weights (f32, TF32 off, as
chip_smoke.py does), takes one Trainer step on make_batch and saves the first
render chunk's RaySOM inputs (predicted Gaussian means and stds [300, 4],
sorted sample distances and alphas [300, 64]) and the (new_means, new_vars,
mask) that the EM inside kernel C's training launch gave the step for them.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "tests" / "_torch_som_kitti_chunk.npz"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from scenerf_tpu_torch import config as C
    from scenerf_tpu_torch import rendering
    from scenerf_tpu_torch.data.synthetic import make_batch
    from scenerf_tpu_torch.model import SceneRF
    from scenerf_tpu_torch.train import Trainer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = C.kitti()
    torch.manual_seed(0)
    with torch.device(dev):
        model = SceneRF(cfg)
    trainer = Trainer(cfg, device=dev, model=model)

    chunks = []
    ray_som = rendering.ray_som

    def recording_ray_som(m, s, sd, alphas, **kw):
        chunks.append([t.detach().clone() for t in (m, s, sd, alphas, *kw["em"])])
        return ray_som(m, s, sd, alphas, **kw)

    rendering.ray_som = recording_ray_som
    try:
        trainer.train_step(make_batch(cfg), torch.Generator(device=dev).manual_seed(0))
    finally:
        rendering.ray_som = ray_som
    m, s, sd, alphas, new_means, new_vars, mask = chunks[0]
    out = {k: v.cpu().numpy() for k, v in dict(
        gauss_means=m, gauss_stds=s, sensor_distances=sd, alphas=alphas,
        kernel_new_means=new_means, kernel_new_vars=new_vars, kernel_mask=mask).items()}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"card: {card}")
    print(f"recorded {len(chunks)} RaySOM chunks; saved the first {sd.shape[0]} rays x "
          f"{sd.shape[1]} samples to {args.out}; means in [{float(m.min()):.3f}, "
          f"{float(m.max()):.3f}], stds in [{float(s.min()):.3f}, {float(s.max()):.3f}], "
          f"alphas in [{float(alphas.min()):.3e}, {float(alphas.max()):.3e}]")


if __name__ == "__main__":
    main()
