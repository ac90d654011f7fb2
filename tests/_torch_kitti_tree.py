"""A small KITTI odometry tree for the port's tests: `scripts/make_fake_kitti.py`
writes each sequence (1241x376 PNGs, KITTI's P2 / Tr, LiDAR scans and exact
poses; one process per sequence, all at once), and the val sequence 08 gets
voxel GT on every 5th frame through the port's io_voxel, as
`make_fake_kitti.py --val` writes it. Imports no JAX."""
import os
import subprocess
import sys

import numpy as np

from scenerf_tpu_torch.data import io_voxel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_kitti_tree(root: str, frames: dict) -> str:
    """`frames`: {sequence: number of frames}. Returns `root`."""
    script = os.path.join(REPO, "scripts", "make_fake_kitti.py")
    procs = [subprocess.Popen([sys.executable, script, "--root", root, "--frames", str(n),
                               "--sequence", seq], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for seq, n in frames.items()]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out
    if "08" in frames:
        vox_dir = os.path.join(root, "dataset", "sequences", "08", "voxels")
        os.makedirs(vox_dir, exist_ok=True)
        labels = np.zeros(256 * 256 * 32, np.uint16)
        labels[: 256 * 256 * 2] = 40
        for i in range(0, frames["08"], 5):
            labels.tofile(os.path.join(vox_dir, f"{i:06d}.label"))
            io_voxel.pack(np.zeros(labels.size, np.uint8)).tofile(
                os.path.join(vox_dir, f"{i:06d}.invalid"))
            io_voxel.pack((labels > 0).astype(np.uint8)).tofile(
                os.path.join(vox_dir, f"{i:06d}.bin"))
    return root
