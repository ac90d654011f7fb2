"""What kernel T decides from the poses, held to the plain version on the CPU.

Kernel T (`ops/csrc/tsdf.cu`) lays its warps' lanes along the grid axis the
frames' camera rows vote for (`ops.tsdf.lane_axis`), cuts the grid into
tiles (`tile_boxes`, `voxel_tiles`), and skips a frame for a whole tile,
before the exact projection, when the tile's corners show it out of view
(`tiles_unseen`). These twins are held here against `integrate_plain`'s
in-view mask (the weight one frame adds where every in-view voxel is
valid): no culled (tile, frame) holds a voxel in view. Poses: the KITTI
sweep of `config.kitti()` on sub-grids of KITTI's voxel size near the
frustum's edges, BundleFusion's sweep, and Hypothesis-drawn cameras on
small grids. No JAX.
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from scenerf_tpu_torch import config as C
from scenerf_tpu_torch import geometry as geo
from scenerf_tpu_torch.cli import reconstruction as rc
from scenerf_tpu_torch.data.synthetic import kitti_calibration
from scenerf_tpu_torch.ops import tsdf as T
from scenerf_tpu_torch.reconstruction import (BF_VOX_ORIGIN, BF_VOXEL_SIZE, KITTI_VOX_ORIGIN,
                                              KITTI_VOXEL_SIZE)

torch.set_num_threads(1)


def in_view_plain(shape, origin, voxel, K, M, H, W) -> torch.Tensor:
    """[X, Y, Z] bool: the voxels `integrate_plain` sees in the frame (K, M):
    with every depth far beyond the grid and a huge truncation, a voxel is
    valid, and gains weight, exactly where it is in view."""
    vols = [torch.full(shape, 255.0), torch.zeros(shape), torch.zeros(shape)]
    T.integrate_plain(*vols, torch.full((1, H, W), 1e6), torch.zeros(1, H, W), K[None],
                      M[None], origin, voxel, 1e7)
    return vols[1] > 0


def hold_cull(shape, origin, voxel, intrs, w2cs, H, W):
    """Every culled (tile, frame) of the twin holds no voxel in view; returns
    (culled tile-frames, tile-frames that hold a voxel in view)."""
    unseen = T.tiles_unseen(shape, origin, voxel, intrs, w2cs, H, W)
    tiles = T.voxel_tiles(shape, T.lane_axis(w2cs))
    assert unseen.shape == (int(tiles.max()) + 1, len(w2cs))
    seen_pairs = 0
    for f in range(len(w2cs)):
        seen = torch.zeros(unseen.shape[0], dtype=torch.bool)
        seen[tiles[in_view_plain(shape, origin, voxel, intrs[f], w2cs[f], H, W)]] = True
        bad = seen & unseen[:, f]
        assert not bool(bad.any()), f"frame {f}: culled tiles {bad.nonzero()[:, 0].tolist()}"
        seen_pairs += int(seen.sum())
    return int(unseen.sum()), seen_pairs


def kitti_sweep():
    cfg = C.kitti()
    K, T_velo_2_cam = kitti_calibration()
    rel = geo.rel_pose_stack(geo.sample_rel_poses(cfg.sweep_step, cfg.sweep_angle,
                                                  cfg.sweep_max_distance))
    w2cs = np.stack([np.linalg.inv(np.linalg.inv(T_velo_2_cam) @ p) for p in rel])
    W, H = cfg.img_size
    return (torch.from_numpy(np.tile(K[None], (len(rel), 1, 1)).astype(np.float32)),
            torch.from_numpy(w2cs.astype(np.float32)), H, W)


# sub-grids of the KITTI grid (voxel offsets from its origin, shape): where
# the vertical edges cut the near columns, where the side edge runs, and the
# first 8 m, which the sweep's later cameras have behind them
KITTI_SUBGRIDS = {"near_top_bottom": ((5, 110, 0), (40, 36, 32)),
                  "side_edge": ((20, 150, 0), (48, 56, 16)),
                  "behind_later_cameras": ((0, 100, 0), (40, 56, 16))}


@pytest.mark.parametrize("name", sorted(KITTI_SUBGRIDS))
def test_kitti_sweep_cull_holds_no_voxel_in_view(name):
    offset, shape = KITTI_SUBGRIDS[name]
    intrs, w2cs, H, W = kitti_sweep()
    assert len(w2cs) == 63
    origin = [float(o + i * KITTI_VOXEL_SIZE) for o, i in zip(KITTI_VOX_ORIGIN, offset)]
    culled, seen = hold_cull(shape, origin, KITTI_VOXEL_SIZE, intrs, w2cs, H, W)
    # neither side is empty: the sub-grid straddles the frustum's edges
    assert culled > 0 and seen > 0, (culled, seen)


def test_lane_axis_follows_the_image_rows():
    """KITTI's camera rows run along the grid's lateral axis j, BundleFusion's
    along x; a camera whose x row runs along world z votes for the better of
    x and y, here x (its y row runs along y)."""
    _, w2cs, _, _ = kitti_sweep()
    assert T.lane_axis(w2cs) == 1
    bf = torch.from_numpy(np.stack([np.linalg.inv(np.asarray(p)) for p in
                                    rc.bf_rel_poses(30.0, 0.2, 2.1).values()]).astype(np.float32))
    assert T.lane_axis(bf) == 0
    side = torch.tensor([[0.0, 0, 1, 0], [0, 1, 0, 0], [-1, 0, 0, 12], [0, 0, 0, 1]])
    assert T.lane_axis(side[None].expand(3, 4, 4)) == 0
    # the majority of the frames decides, x a tie
    assert T.lane_axis(torch.stack([w2cs[0], w2cs[1], side])) == 1
    assert T.lane_axis(torch.stack([side, w2cs[0]])) == 0
    with pytest.raises(ValueError):
        T.tile_layout(2)


@pytest.mark.parametrize("shape", [(37, 53, 11), (120, 120, 96), (1, 1, 1), (33, 8, 9),
                                   (32, 8, 4), (65, 17, 130)])
@pytest.mark.parametrize("axis", [0, 1])
def test_tiles_cover_the_grid_once(shape, axis):
    """Every voxel lies in exactly one tile, and `voxel_tiles` names the
    tile whose box holds it; a tile spans at most 32 x 8 x 4 voxels, its
    runs along z."""
    start, count = T.tile_boxes(shape, axis)
    tiles = T.voxel_tiles(shape, axis)
    assert int(count.prod(1).sum()) == math.prod(shape)
    assert bool((count >= 1).all())
    (A, B, L), ext = T.tile_layout(axis)
    assert (A, B, L) == (axis, 1 - axis, 2)
    assert ext == (T.TILE_LANES, T.TILE_WARPS, T.TILE_RUN)
    assert bool((count[:, A] <= T.TILE_LANES).all() and (count[:, L] <= T.TILE_RUN).all())
    idx = torch.stack(torch.meshgrid(*[torch.arange(n) for n in shape], indexing="ij"), -1)
    s, c = start[tiles], count[tiles]
    assert bool(((idx >= s) & (idx < s + c)).all())


def test_bf_sweep_cull_holds_no_voxel_in_view():
    """BundleFusion's 33-pose sweep on a 48x40x24 corner of its grid."""
    poses = list(rc.bf_rel_poses(30.0, 0.2, 2.1).values())[::4]
    w2cs = torch.from_numpy(np.stack([np.linalg.inv(np.asarray(p)) for p in poses])
                            .astype(np.float32))
    K = torch.tensor([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]])
    intrs = K.expand(len(poses), 3, 3).contiguous()
    origin = [float(o + i * BF_VOXEL_SIZE) for o, i in zip(BF_VOX_ORIGIN, (60, 30, 0))]
    culled, seen = hold_cull((48, 40, 24), origin, BF_VOXEL_SIZE, intrs, w2cs, 480, 640)
    assert culled > 0 and seen > 0, (culled, seen)


def _rotation(q):
    a, b, c, d = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([[a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
                     [2 * (b * c + a * d), a * a - b * b + c * c - d * d, 2 * (c * d - a * b)],
                     [2 * (b * d - a * c), 2 * (c * d + a * b), a * a - b * b - c * c + d * d]])


_coord = st.floats(-4.0, 4.0, allow_nan=False)


@settings(max_examples=25, deadline=None, derandomize=True)
@given(quats=st.lists(st.tuples(*[st.floats(-1.0, 1.0).filter(lambda x: abs(x) > 1e-3)] * 4),
                      min_size=1, max_size=3),
       ts=st.lists(st.tuples(_coord, _coord, _coord), min_size=3, max_size=3),
       fx=st.floats(4.0, 80.0), cx=st.floats(-4.0, 30.0), fy=st.floats(4.0, 80.0),
       cy=st.floats(-4.0, 24.0), hw=st.tuples(st.integers(4, 24), st.integers(4, 32)),
       shape=st.tuples(*[st.integers(2, 40)] * 3), voxel=st.floats(0.05, 0.4),
       origin=st.tuples(_coord, _coord, _coord))
def test_drawn_cameras_cull_holds_no_voxel_in_view(quats, ts, fx, cx, fy, cy, hw, shape,
                                                   voxel, origin):
    H, W = hw
    w2cs = []
    for q, t in zip(quats, ts):
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = _rotation(q), t
        w2cs.append(M)
    w2cs = torch.from_numpy(np.stack(w2cs).astype(np.float32))
    K = torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=torch.float32)
    hold_cull(shape, origin, voxel, K.expand(len(w2cs), 3, 3).contiguous(), w2cs, H, W)
