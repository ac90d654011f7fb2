"""SemanticKITTI odometry dataset in numpy: scans, source frames, LiDAR depth,
ICP-refined relative poses, voxel GT, and the fixed-shape batch of the model.
The port's own copy of `scenerf_tpu/data/kitti.py`.

A scan is an anchor (input) frame plus the following frames within
`sequence_distance` meters of travel, at least `frames_interval` apart; a
frame with no such successor has no scan. Sequences 00-07, 09 and 10 train;
the val split anchors on sequence 08's voxel-GT frames (`voxels/*.bin`) whose
id is a multiple of 5, minus the frames with corrupt GT.

An item holds the anchor's normalized frame and, for each of up to
`n_sources` source frames of its scan (drawn at random when the scan has
more, else all of them in order), the source and target (the frame before
it) images, the source's LiDAR depth at `eval_depth` (a random subsample of
`n_rays` returns), and the ICP-refined `T_source2infer` / `T_source2target`
(read from, or computed into, the `TransformCache` under `preprocess_root`).
The draws come from `np.random.default_rng(seed)` in the JAX package's
order (the source ids, then each source's LiDAR subsample), so the same
seed gives the same items. `to_model_batch` pads a list of items to the
model's batch contract (data/synthetic.py) with masks.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from scenerf_tpu_torch.config import SceneRFConfig
from scenerf_tpu_torch.data import calib as C
from scenerf_tpu_torch.data import io_voxel
from scenerf_tpu_torch.data.icp import TransformCache, compute_transformation

SPLITS = {
    "train": ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"],
    "val": ["08"],
    "test": ["11", "12", "13", "14", "15", "16", "17", "18", "19", "20", "21"],
}

# frames whose GT voxels are corrupt in the val split
VAL_ERROR_FRAMES = {"000000", "000195", "001325", "001690", "001700", "001995",
                    "002740", "002750", "003000", "003325", "003740", "003745",
                    "004070"}

IMG_W, IMG_H = 1220, 370
SCENE_SIZE = (51.2, 51.2, 6.4)
VOX_ORIGIN = np.array([0, -25.6, -2])
VOXEL_SIZE = 0.2


class KittiDataset:
    def __init__(self, split: str, root: str, preprocess_root: str,
                 frames_interval: float = 0.4, sequence_distance: float = 10.0,
                 n_sources: int = 1, eval_depth: float = 80.0,
                 sequences: Optional[Sequence[str]] = None,
                 selected_frames: Optional[Sequence[str]] = None, n_rays: int = 1200,
                 load_voxels: bool = False, seed: Optional[int] = None):
        """`sequences` overrides the split's; `selected_frames` keeps only
        those anchor ids. `preprocess_root` is read (and written) only when
        an item has sources."""
        self.root = root
        self.transform_root = os.path.join(preprocess_root, "transform")
        self.split = split
        self.sequences = list(sequences) if sequences else SPLITS[split]
        self.frames_interval = frames_interval
        self.sequence_distance = sequence_distance
        self.n_sources = n_sources
        self.eval_depth = eval_depth
        self.n_rays = n_rays
        self.load_voxels = load_voxels
        self.rng = np.random.default_rng(seed)
        self.scans: List[Dict] = []
        for sequence in self.sequences:
            self._walk_sequence(sequence, selected_frames)

    def _seq_dir(self, sequence: str) -> str:
        return os.path.join(self.root, "dataset", "sequences", sequence)

    def _walk_sequence(self, sequence: str, selected_frames):
        poses_all = C.read_poses(os.path.join(self.root, "dataset", "poses", sequence + ".txt"))
        cal = C.read_calib(os.path.join(self._seq_dir(sequence), "calib.txt"))
        T_cam0_2_cam2 = cal["T_cam0_2_cam2"]
        T_velo_2_cam = T_cam0_2_cam2 @ cal["Tr"]
        # val anchors on the frames with voxel GT, train on every image
        sub = ("voxels", "*.bin") if self.split == "val" else ("image_2", "*.png")
        for anchor_path in sorted(glob.glob(os.path.join(self._seq_dir(sequence), *sub))):
            frame_id = os.path.splitext(os.path.basename(anchor_path))[0]
            if self.split == "val" and (int(frame_id) % 5 != 0 or frame_id in VAL_ERROR_FRAMES):
                continue
            if selected_frames is not None and frame_id not in selected_frames:
                continue
            scan = self._build_scan(sequence, frame_id, poses_all, cal["P2"], T_velo_2_cam,
                                    T_cam0_2_cam2)
            if scan is not None:
                self.scans.append(scan)

    def _build_scan(self, sequence, frame_id, poses_all, P, T_velo_2_cam, T_cam0_2_cam2):
        """The anchor and its following frames within sequence_distance meters,
        at least frames_interval apart; None when no frame follows."""
        img_dir = os.path.join(self._seq_dir(sequence), "image_2")
        lidar_dir = os.path.join(self._seq_dir(sequence), "velodyne")
        rel_frame_ids, img_paths, lidar_paths, poses, distances = [], [], [], [], []
        distance = 0.0
        cnt = -1
        while True:
            cnt += 1
            rel_id = f"{int(frame_id) + cnt:06d}"
            img_path = os.path.join(img_dir, rel_id + ".png")
            if not os.path.exists(img_path):
                break
            current_pose = poses_all[int(rel_id)]
            if poses:
                prev, cur = C.dump_xyz(poses[-1]), C.dump_xyz(current_pose)
                rel_distance = float(np.hypot(prev[0] - cur[0], prev[2] - cur[2]))
                distance += rel_distance
                if rel_distance < self.frames_interval:
                    continue
                if distance > self.sequence_distance:
                    break
            rel_frame_ids.append(rel_id)
            img_paths.append(img_path)
            lidar_paths.append(os.path.join(lidar_dir, rel_id + ".bin"))
            poses.append(current_pose)
            distances.append(distance)
        if len(poses) <= 1:
            return None
        return {"frame_id": frame_id, "sequence": sequence, "img_paths": img_paths,
                "lidar_paths": lidar_paths, "T_velo_2_cam": T_velo_2_cam, "P": P,
                "T_cam0_2_cam2": T_cam0_2_cam2, "T_cam2_2_cam0": np.linalg.inv(T_cam0_2_cam2),
                "poses": np.stack(poses, axis=0), "distances": distances,
                "rel_frame_ids": rel_frame_ids}

    def __len__(self):
        return len(self.scans)

    def _refined_transforms(self, scan, source_id: int) -> Dict[str, np.ndarray]:
        cache = TransformCache(self.transform_root, scan["sequence"], self.frames_interval)
        target_id = source_id - 1
        poses, lidar = scan["poses"], scan["lidar_paths"]
        return cache.get_or_compute(scan["frame_id"], source_id, lambda: compute_transformation(
            lidar[source_id], lidar[0], lidar[target_id], poses[source_id], poses[0],
            poses[target_id], scan["T_velo_2_cam"], scan["T_cam0_2_cam2"]))

    def __getitem__(self, index: int) -> Dict:
        scan = self.scans[index]
        P, T_velo_2_cam, distances = scan["P"], scan["T_velo_2_cam"], scan["distances"]
        n_sources = min(len(distances) - 1, self.n_sources)
        keys = ("img_sources", "img_targets", "img_input_sources", "lidar_depths",
                "loc2d_with_depths", "T_source2infers", "T_source2targets", "source_distances",
                "source_frame_ids")
        src: Dict[str, list] = {k: [] for k in keys}
        for d_id in range(n_sources):
            if self.n_sources < len(distances):
                source_id = int(self.rng.integers(1, len(distances)))
            else:
                source_id = d_id + 1
            src["source_distances"].append(distances[source_id])
            src["source_frame_ids"].append(scan["rel_frame_ids"][source_id])
            img_source = C.read_rgb(scan["img_paths"][source_id])
            src["img_sources"].append(img_source)
            src["img_targets"].append(C.read_rgb(scan["img_paths"][source_id - 1]))
            src["img_input_sources"].append(C.normalize_rgb(img_source))

            loc2d, depth, _ = C.lidar_to_depth(
                C.read_lidar(scan["lidar_paths"][source_id]), P, T_velo_2_cam, (IMG_W, IMG_H),
                max_depth=self.eval_depth)
            if self.n_rays < depth.shape[0]:
                idx = self.rng.choice(depth.shape[0], size=self.n_rays, replace=False)
                loc2d, depth = loc2d[idx], depth[idx]
            src["loc2d_with_depths"].append(loc2d.astype(np.float32))
            src["lidar_depths"].append(depth.astype(np.float32))

            T = self._refined_transforms(scan, source_id)
            src["T_source2infers"].append(T["T_source2infer"].astype(np.float32))
            src["T_source2targets"].append(T["T_source2target"].astype(np.float32))

        data = {
            "frame_id": scan["frame_id"],
            "sequence": scan["sequence"],
            "img_input": C.normalize_rgb(C.read_rgb(scan["img_paths"][0])),
            "cam_K": P[0:3, 0:3].astype(np.float32),
            "P": P,
            "T_velo_2_cam": T_velo_2_cam.astype(np.float32),
            "T_cam2_2_cam0": scan["T_cam2_2_cam0"].astype(np.float32),
            "T_cam0_2_cam2": scan["T_cam0_2_cam2"].astype(np.float32),
            **src,
        }
        if self.load_voxels:
            vox_dir = os.path.join(self._seq_dir(scan["sequence"]), "voxels")
            data["target_1_1"] = io_voxel.read_semantic_voxels(
                os.path.join(vox_dir, scan["frame_id"] + ".label"),
                os.path.join(vox_dir, scan["frame_id"] + ".invalid"))
            (data["projected_pix_1"], data["fov_mask_1"],
             data["sensor_distance_1"]) = C.vox2pix(T_velo_2_cam, data["cam_K"], VOX_ORIGIN,
                                                    VOXEL_SIZE, IMG_W, IMG_H, SCENE_SIZE)
        return data


def to_model_batch(items: List[Dict], cfg: SceneRFConfig) -> Dict[str, np.ndarray]:
    """Items -> the model's fixed-shape batch: `cfg.n_sources` source slots
    and `cfg.n_gt_depth` LiDAR rows per source, the rest padded and masked
    out (identity poses in the empty source slots, depth 1 in the empty
    rows)."""
    B, S, G = len(items), cfg.n_sources, cfg.n_gt_depth
    H, W = items[0]["img_input"].shape[:2]
    out = {
        "img_input": np.stack([it["img_input"] for it in items]).astype(np.float32),
        "cam_K": np.stack([it["cam_K"] for it in items]).astype(np.float32),
        "T_source2infer": np.zeros((B, S, 4, 4), np.float32),
        "T_source2target": np.zeros((B, S, 4, 4), np.float32),
        "img_sources": np.zeros((B, S, H, W, 3), np.float32),
        "img_targets": np.zeros((B, S, H, W, 3), np.float32),
        "source_mask": np.zeros((B, S), np.float32),
        "gt_pix": np.zeros((B, S, G, 2), np.float32),
        "gt_depth": np.ones((B, S, G), np.float32),
        "gt_mask": np.zeros((B, S, G), np.float32),
    }
    for b, it in enumerate(items):
        n = min(len(it["img_sources"]), S)
        for s in range(n):
            out["T_source2infer"][b, s] = it["T_source2infers"][s]
            out["T_source2target"][b, s] = it["T_source2targets"][s]
            out["img_sources"][b, s] = it["img_sources"][s]
            out["img_targets"][b, s] = it["img_targets"][s]
            out["source_mask"][b, s] = 1.0
            g = min(len(it["lidar_depths"][s]), G)
            out["gt_pix"][b, s, :g] = it["loc2d_with_depths"][s][:g]
            out["gt_depth"][b, s, :g] = it["lidar_depths"][s][:g]
            out["gt_mask"][b, s, :g] = 1.0
        for s in range(n, S):
            out["T_source2infer"][b, s] = np.eye(4)
            out["T_source2target"][b, s] = np.eye(4)
    return out
