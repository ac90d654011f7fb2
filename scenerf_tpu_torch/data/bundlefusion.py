"""BundleFusion (indoor RGB-D) dataset in numpy: scans, source frames, depth
PNGs and per-frame poses, and the fixed-shape batch of the model. The
port's own copy of `scenerf_tpu/data/bundlefusion.py`.

A scan is a window of `n_frames + 1` frames spaced `frame_interval` apart,
centred on the infer frame (a multiple of `infer_frame_interval` whose
window lies inside the sequence, and not listed in `bf_error_frames.txt`).
Seven scenes train and copyroom validates. Poses are read per frame (no
ICP). The 16-bit depth PNGs (millimetres) are the ground truth of the depth
evaluation and of the fused scene-completion occupancy.

An item holds the infer frame (normalized and raw), its depth and, for each
of up to `n_sources` sources of the window (drawn at random with
`np.random.default_rng(seed)` when the window has more, else all of them in
order), the source and target images (the target is the window frame
before the source: the window's last frame for source 0), the source's
depth and its `T_source2infer` / `T_source2target`. `cam_K` (color) renders;
`cam_K_depth` fuses the depth maps. Images and depth PNGs are read with
PIL.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from scenerf_tpu_torch.config import SceneRFConfig
from scenerf_tpu_torch.data.calib import normalize_rgb

SPLITS = {
    "train": ["apt0", "apt1", "apt2", "office0", "office1", "office2", "office3"],
    "val": ["copyroom"],
    "all": ["apt0", "apt1", "apt2", "office0", "office1", "office2", "office3", "copyroom"],
}
IMG_W, IMG_H = 640, 480
ERROR_FRAMES_PATH = os.path.join(os.path.dirname(__file__), "bf_error_frames.txt")


def read_camera_params(path: str):
    """info.txt -> (color K 3x3, depth K 3x3), f64."""
    cam_K_color = cam_K_depth = None
    with open(path) as f:
        for line in f:
            if line == "\n":
                break
            if "=" not in line:
                continue
            key, value = line.split("=", 1)
            key, value = key.strip(), value.strip()
            if key == "m_calibrationColorIntrinsic":
                cam_K_color = np.array([float(x) for x in value.split()]).reshape(4, 4)
            if key == "m_calibrationDepthIntrinsic":
                cam_K_depth = np.array([float(x) for x in value.split()]).reshape(4, 4)
    return cam_K_color[:3, :3], cam_K_depth[:3, :3]


def read_pose(path: str) -> np.ndarray:
    """A frame's pose.txt (4 rows of 4 numbers) -> 4x4 camera -> world, f64."""
    pose = np.identity(4)
    with open(path) as f:
        rows = [line for line in f if line.strip()]
    for i, line in enumerate(rows):
        pose[i, :] = np.array(line.split(), dtype=np.float64)
    return pose


def read_rgb(path: str) -> np.ndarray:
    """RGB [H, W, 3] f32 in [0, 1], uncropped."""
    from PIL import Image

    return np.array(Image.open(path).convert("RGB"), dtype=np.float32) / 255.0


def read_depth(path: str) -> np.ndarray:
    """16-bit depth PNG in millimetres -> metres [H, W] f64 (0: no depth)."""
    from PIL import Image

    return np.asarray(Image.open(path)).astype(np.float64) / 1000.0


def read_error_frames() -> set:
    """The frames left out of every split, as "<scene>_<frame id>"."""
    with open(ERROR_FRAMES_PATH) as f:
        return {line.strip() for line in f}


class BundlefusionDataset:
    def __init__(self, split: str, root: str, n_sources: int = 1, frame_interval: int = 4,
                 n_frames: int = 16, infer_frame_interval: int = 2,
                 select_scans: Optional[Sequence[str]] = None, seed: Optional[int] = None,
                 sequences: Optional[Sequence[str]] = None):
        """`sequences` overrides the split's scenes; `select_scans` keeps only
        those infer frame ids."""
        self.root = root
        self.sequences = list(sequences) if sequences else SPLITS[split]
        self.n_sources = n_sources
        self.frame_interval = frame_interval
        self.n_frames = n_frames
        self.infer_frame_interval = infer_frame_interval
        self.img_W, self.img_H = IMG_W, IMG_H
        self.rng = np.random.default_rng(seed)
        self.error_frames = read_error_frames()

        self.scans: List[Dict] = []
        half = self.n_frames // 2
        for sequence in self.sequences:
            cam_K_color, cam_K_depth = read_camera_params(os.path.join(root, sequence,
                                                                       "info.txt"))
            rgb_paths = glob.glob(os.path.join(root, sequence, "*.color.jpg"))
            for rgb_path in sorted(rgb_paths):
                name = os.path.splitext(os.path.basename(rgb_path))[0]
                frame_id = float(name[6:12])
                if f"{sequence}_{int(frame_id):06d}" in self.error_frames:
                    continue
                if frame_id % self.infer_frame_interval != 0:
                    continue
                if frame_id < half * self.frame_interval:
                    continue
                if frame_id > (len(rgb_paths) - 1 - half * self.frame_interval):
                    continue
                rel_frame_ids = [f"{int(frame_id) + i * self.frame_interval:06d}"
                                 for i in range(-half, half + 1)]
                if select_scans is not None and rel_frame_ids[half] not in select_scans:
                    continue
                self.scans.append({"sequence": sequence, "frame_id": rel_frame_ids[half],
                                   "rel_frame_ids": rel_frame_ids, "cam_K_color": cam_K_color,
                                   "cam_K_depth": cam_K_depth})

    def __len__(self):
        return len(self.scans)

    def _frame_path(self, sequence: str, frame_id: str, kind: str) -> str:
        return os.path.join(self.root, sequence, f"frame-{frame_id}.{kind}")

    def __getitem__(self, index: int) -> Dict:
        scan = self.scans[index]
        sequence, rel = scan["sequence"], scan["rel_frame_ids"]
        infer_id = self.n_frames // 2
        frame_id = rel[infer_id]

        def path(fid, kind):
            return self._frame_path(sequence, fid, kind)

        img_input_raw = read_rgb(path(frame_id, "color.jpg"))
        infer_depth = read_depth(path(frame_id, "depth.png"))
        infer_pose = read_pose(path(frame_id, "pose.txt"))

        idx = np.delete(np.arange(self.n_frames + 1), infer_id)
        keys = ("img_sources", "img_targets", "source_depths", "T_source2infers",
                "T_source2targets", "source_frame_ids")
        src: Dict[str, list] = {k: [] for k in keys}
        for d_id in range(min(len(idx), self.n_sources)):
            if self.n_sources < len(rel):
                source_id = int(self.rng.choice(idx, 1)[0])
            else:
                source_id = int(idx[d_id])
            target_id = source_id - 1  # rel[-1], the window's last frame, for source 0
            src["source_frame_ids"].append(rel[source_id])
            src["img_sources"].append(read_rgb(path(rel[source_id], "color.jpg")))
            src["img_targets"].append(read_rgb(path(rel[target_id], "color.jpg")))
            source_pose = read_pose(path(rel[source_id], "pose.txt"))
            target_pose = read_pose(path(rel[target_id], "pose.txt"))
            src["T_source2infers"].append(
                (np.linalg.inv(infer_pose) @ source_pose).astype(np.float32))
            src["T_source2targets"].append(
                (np.linalg.inv(target_pose) @ source_pose).astype(np.float32))
            src["source_depths"].append(read_depth(path(rel[source_id], "depth.png")))

        return {
            "frame_id": frame_id,
            "sequence": sequence,
            "img_input": normalize_rgb(img_input_raw),
            "img_input_original": img_input_raw,
            "infer_depth": infer_depth,
            "cam_K": scan["cam_K_color"].astype(np.float32),
            "cam_K_depth": scan["cam_K_depth"].astype(np.float32),
            **src,
        }


def to_model_batch(items: List[Dict], cfg: SceneRFConfig) -> Dict[str, np.ndarray]:
    """Items -> the model's fixed-shape batch (data/synthetic.py's contract):
    `cfg.n_sources` source slots (identity poses in the empty ones) and, per
    source, `cfg.n_gt_depth` GT pixels drawn without replacement from its
    nonzero depth pixels by a fresh `default_rng(0)` on every call (so every
    batch draws the same pixels), the rest padded and masked out."""
    B, S, G = len(items), cfg.n_sources, cfg.n_gt_depth
    H, W = items[0]["img_input"].shape[:2]
    rng = np.random.default_rng(0)
    out = {
        "img_input": np.stack([it["img_input"] for it in items]).astype(np.float32),
        "cam_K": np.stack([it["cam_K"] for it in items]).astype(np.float32),
        "T_source2infer": np.tile(np.eye(4, dtype=np.float32), (B, S, 1, 1)),
        "T_source2target": np.tile(np.eye(4, dtype=np.float32), (B, S, 1, 1)),
        "img_sources": np.zeros((B, S, H, W, 3), np.float32),
        "img_targets": np.zeros((B, S, H, W, 3), np.float32),
        "source_mask": np.zeros((B, S), np.float32),
        "gt_pix": np.zeros((B, S, G, 2), np.float32),
        "gt_depth": np.ones((B, S, G), np.float32),
        "gt_mask": np.zeros((B, S, G), np.float32),
    }
    for b, it in enumerate(items):
        for s in range(min(len(it["img_sources"]), S)):
            out["T_source2infer"][b, s] = it["T_source2infers"][s]
            out["T_source2target"][b, s] = it["T_source2targets"][s]
            out["img_sources"][b, s] = it["img_sources"][s]
            out["img_targets"][b, s] = it["img_targets"][s]
            out["source_mask"][b, s] = 1.0
            depth = it["source_depths"][s]
            ys, xs = np.nonzero(depth > 0)
            if len(ys):
                take = min(G, len(ys))
                sel = rng.choice(len(ys), size=take, replace=False)
                out["gt_pix"][b, s, :take] = np.stack([xs[sel], ys[sel]], axis=-1)
                out["gt_depth"][b, s, :take] = depth[ys[sel], xs[sel]]
                out["gt_mask"][b, s, :take] = 1.0
    return out
