"""The SemanticKITTI val reader of the reconstruction chain, in numpy: the
port's own copy of the scan walk and the anchor-frame fields of
`scenerf_tpu/data/kitti.py`.

A scan is an anchor frame plus the following frames within
`sequence_distance` meters of travel, at least `frames_interval` apart; a
frame with no such successor has no scan. The val split anchors on sequence
08's voxel-GT frames (`voxels/*.bin`) whose id is a multiple of 5, minus the
frames with corrupt GT. Items carry what reconstruction reads: `img_input`,
`cam_K`, `T_velo_2_cam`, `frame_id`, `sequence` and, with `load_voxels`,
`target_1_1` and `fov_mask_1`. Source frames, LiDAR and ICP-refined poses are
not ported yet (`n_sources > 0` raises), so `preprocess_root`, where the
ICP transforms live, is not read.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List

import numpy as np

from scenerf_tpu_torch.data import calib as C
from scenerf_tpu_torch.data import io_voxel

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
                 n_sources: int = 0, load_voxels: bool = False):
        if n_sources > 0:
            raise NotImplementedError(
                "source frames, LiDAR depth and ICP poses are not ported yet "
                "(ROADMAP Queue 1 #6, the data slice): use n_sources=0")
        self.root = root
        self.split = split
        self.sequences = SPLITS[split]
        self.frames_interval = frames_interval
        self.sequence_distance = sequence_distance
        self.load_voxels = load_voxels
        self.scans: List[Dict] = []
        for sequence in self.sequences:
            self._walk_sequence(sequence)

    def _seq_dir(self, sequence: str) -> str:
        return os.path.join(self.root, "dataset", "sequences", sequence)

    def _walk_sequence(self, sequence: str):
        poses_all = C.read_poses(os.path.join(self.root, "dataset", "poses", sequence + ".txt"))
        cal = C.read_calib(os.path.join(self._seq_dir(sequence), "calib.txt"))
        T_velo_2_cam = cal["T_cam0_2_cam2"] @ cal["Tr"]
        # val anchors on the frames with voxel GT, train on every image
        sub = ("voxels", "*.bin") if self.split == "val" else ("image_2", "*.png")
        for anchor_path in sorted(glob.glob(os.path.join(self._seq_dir(sequence), *sub))):
            frame_id = os.path.splitext(os.path.basename(anchor_path))[0]
            if self.split == "val" and (int(frame_id) % 5 != 0 or frame_id in VAL_ERROR_FRAMES):
                continue
            scan = self._build_scan(sequence, frame_id, poses_all, cal["P2"], T_velo_2_cam)
            if scan is not None:
                self.scans.append(scan)

    def _build_scan(self, sequence, frame_id, poses_all, P, T_velo_2_cam):
        """The anchor and its following frames within sequence_distance meters,
        at least frames_interval apart; None when no frame follows."""
        img_dir = os.path.join(self._seq_dir(sequence), "image_2")
        img_paths, poses = [], []
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
            img_paths.append(img_path)
            poses.append(current_pose)
        if len(poses) <= 1:
            return None
        return {"frame_id": frame_id, "sequence": sequence, "img_paths": img_paths,
                "T_velo_2_cam": T_velo_2_cam, "P": P}

    def __len__(self):
        return len(self.scans)

    def __getitem__(self, index: int) -> Dict:
        scan = self.scans[index]
        data = {
            "frame_id": scan["frame_id"],
            "sequence": scan["sequence"],
            "img_input": C.normalize_rgb(C.read_rgb(scan["img_paths"][0])),
            "cam_K": scan["P"][0:3, 0:3].astype(np.float32),
            "T_velo_2_cam": scan["T_velo_2_cam"].astype(np.float32),
        }
        if self.load_voxels:
            vox_dir = os.path.join(self._seq_dir(scan["sequence"]), "voxels")
            data["target_1_1"] = io_voxel.read_semantic_voxels(
                os.path.join(vox_dir, scan["frame_id"] + ".label"),
                os.path.join(vox_dir, scan["frame_id"] + ".invalid"))
            _, data["fov_mask_1"], _ = C.vox2pix(
                scan["T_velo_2_cam"], data["cam_K"], VOX_ORIGIN, VOXEL_SIZE, IMG_W, IMG_H,
                SCENE_SIZE)
        return data
