"""Kernel K5's host-side dispatch, `ops.norm.plan`, on the CPU: the path and
tiling each batch norm site of the KITTI B7 spherical U-Net gets.

The sites are those of a train-mode encode of SceneRF(kitti()) run on the
meta device (shapes only, nothing computed): 192 sites of 37 distinct
(shape, activation, residual) configurations. Every configuration gets a
path in f32 and bf16, forward and backward; the cluster path's tiling
covers the tensor, keeps a block's shared memory within what two blocks an
SM leave it (and so within the 227 KB a block may have) and matches the
kernels' layout formula; channel-first inputs take their own kernels. The
card runs both paths against the plain versions
(tests/test_torch_kernels_cuda.py).
"""
import math

import pytest
import torch

from scenerf_tpu_torch import config as C
from scenerf_tpu_torch.data.synthetic import default_intrinsics
from scenerf_tpu_torch.encoder.norm import FusedBatchNorm
from scenerf_tpu_torch.model import SceneRF
from scenerf_tpu_torch.ops import norm as N


@pytest.fixture(scope="module")
def b7_sites():
    """(shape, act, residual) of every batch norm site of a train-mode encode
    of SceneRF(kitti()) on the meta device."""
    cfg = C.kitti()
    with torch.device("meta"):
        model = SceneRF(cfg)
    K = default_intrinsics(cfg)
    maps = {s: torch.empty(m.shape, dtype=torch.as_tensor(m).dtype, device="meta")
            for s, m in model.compute_sphere_maps(K).items()}
    sites = []

    def record(mod, args, kwargs):
        r = args[1] if len(args) > 1 else kwargs.get("residual")
        sites.append((tuple(args[0].shape), mod.act, r is not None))

    for m in model.modules():
        if isinstance(m, FusedBatchNorm):
            m.register_forward_pre_hook(record, with_kwargs=True)
    model.train()
    with torch.no_grad():
        model.encode(torch.empty(1, cfg.img_size[1], cfg.img_size[0], 3, device="meta"), K,
                     sphere_maps=maps)
    return sites


def test_plan_covers_every_b7_site(b7_sites):
    assert len(b7_sites) == 192
    configs = sorted(set(b7_sites), key=lambda k: -math.prod(k[0]))
    assert len(configs) == 37
    cluster_sites = {}
    for shape, act, res in configs:
        M, Cn = math.prod(shape[:-1]), shape[-1]
        for itemsize in (4, 2):
            vector = Cn % (16 // itemsize) == 0
            assert vector  # every B7 width is a multiple of 8 channels
            for direction in ("forward", "backward"):
                p = N.plan(M, Cn, itemsize, vector, direction, act, res)
                assert p.path in ("cluster", "streaming"), (shape, act, res, p)
                assert N.plan(M, Cn, itemsize, vector, direction, act, res,
                              channel_first=True).path == "channel-first"
                if p.path == "streaming":
                    continue
                key = (itemsize, direction)
                cluster_sites[key] = cluster_sites.get(key, 0) + b7_sites.count((shape, act, res))
                arrays = (1 + res if direction == "forward"
                          else 2 + (res and act != "identity"))
                width = p.sv * 16 // itemsize
                assert 1 <= p.cluster <= N.CLUSTER_MAX and p.cluster & (p.cluster - 1) == 0
                assert p.cluster * p.rows >= M > (p.cluster - 1) * p.rows
                assert p.slices * width >= Cn and p.sv * 16 <= N.SLICE_BYTES
                assert p.smem == N.cluster_smem(p.rows, p.sv, 16, arrays, width)
                assert p.smem <= N.SMEM_PAIR <= 227 * 1024
    # the small sites (/8 and deeper: every M up to 7,191 rows) take one
    # launch a direction; the decoder's full-resolution sites stream
    for shape, act, res in configs:
        M, Cn = math.prod(shape[:-1]), shape[-1]
        for itemsize in (4, 2):
            for direction in ("forward", "backward"):
                path = N.plan(M, Cn, itemsize, True, direction, act, res).path
                if M <= 7191:
                    assert path == "cluster", (shape, act, res, itemsize, direction)
                if M >= 169500:
                    assert path == "streaming", (shape, act, res, itemsize, direction)
    assert all(n >= 110 for n in cluster_sites.values()), cluster_sites


@pytest.mark.parametrize("itemsize", [4, 2])
def test_plan_scalar_path_and_growth(itemsize):
    """C not a multiple of the vector width takes single-channel packs (a
    slice of at most 32 bytes, the next power of two channels); a small M
    keeps one block a slice; a long one grows the cluster until the grid
    has a block an SM or each block is down to two rows a thread."""
    p = N.plan(7, 3, itemsize, False, "forward", "silu", False)
    assert (p.path, p.cluster, p.sv, p.rows, p.slices) == ("cluster", 1, 4, 7, 1)
    p = N.plan(1, 80, itemsize, True, "backward", "leaky", True)
    assert (p.cluster, p.rows) == (1, 1)
    p = N.plan(7191, 480, itemsize, True, "forward", "silu", False)
    assert p.slices * p.cluster >= N.SMS or p.rows < 4 * N.THREADS // p.sv
    assert N.plan(10 ** 7, 80, itemsize, True, "forward", "silu", False).path == "streaming"
    # the boundary: the largest M on the cluster path fills 16 blocks of at
    # most SMEM_PAIR bytes, and the next M does not fit them
    lo, hi = 1, 1 << 22
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if N.plan(mid, 288, itemsize, True, "backward", "leaky", True).path == "cluster":
            lo = mid
        else:
            hi = mid
    p = N.plan(lo, 288, itemsize, True, "backward", "leaky", True)
    assert p.cluster == N.CLUSTER_MAX and p.smem <= N.SMEM_PAIR
    assert N.cluster_smem(-(-hi // N.CLUSTER_MAX), p.sv, 16, 3, p.sv * 16 // itemsize) \
        > N.SMEM_PAIR
