"""SemanticKITTI voxel IO in numpy: bit packing and unpacking, the
label/invalid readers and the class remap. The port's own copy of
`scenerf_tpu/data/io_voxel.py`'s readers and `pack`; the 20-class learning
map is the standard SemanticKITTI metadata, embedded so no yaml file is
needed.
"""
from __future__ import annotations

import numpy as np

# SemanticKITTI learning_map (raw label -> train id, 20 classes incl. empty)
LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}

VOXEL_SHAPE = (256, 256, 32)


def unpack(compressed: np.ndarray) -> np.ndarray:
    """Bit-packed uint8 -> one byte per voxel (most significant bit first)."""
    out = np.zeros(compressed.shape[0] * 8, dtype=np.uint8)
    for i in range(8):
        out[i::8] = (compressed >> (7 - i)) & 1
    return out


def pack(array: np.ndarray) -> np.ndarray:
    """Binary array -> bit-packed uint8 (most significant bit first): the
    inverse of `unpack` for a length that is a multiple of 8."""
    a = array.reshape(-1).astype(np.uint8)
    out = np.zeros(a.shape[0] // 8, dtype=np.uint8)
    for i in range(8):
        out |= a[i::8] << (7 - i)
    return out


def get_remap_lut() -> np.ndarray:
    """Raw-label -> train-id LUT with 0 meaning 'empty' and unlabeled -> 255."""
    maxkey = max(LEARNING_MAP)
    lut = np.zeros(maxkey + 100, dtype=np.int32)
    lut[list(LEARNING_MAP)] = list(LEARNING_MAP.values())
    lut[lut == 0] = 255
    lut[0] = 0
    return lut


def read_label(path: str) -> np.ndarray:
    """uint16 semantic labels per voxel, as f32."""
    return np.fromfile(path, dtype=np.uint16).astype(np.float32)


def read_invalid(path: str) -> np.ndarray:
    """Bit-packed invalid mask, as f32 0/1 per voxel."""
    return unpack(np.fromfile(path, dtype=np.uint8)).astype(np.float32)


def read_semantic_voxels(label_path: str, invalid_path: str,
                         shape=VOXEL_SHAPE) -> np.ndarray:
    """Remapped [256, 256, 32] training labels, invalid voxels set to 255."""
    label = get_remap_lut()[read_label(label_path).astype(np.uint16)].astype(np.float32)
    label[np.isclose(read_invalid(invalid_path), 1)] = 255
    return label.reshape(shape)
