"""Kernel G-bwd's shared gradient buffers and kernels G/G-bwd's lane groups,
on the CPU (the plain versions; the wiring is the card's):

* several chunk gathers on one pyramid through `share_pyramid_grads` give
  the level gradients of autograd of the plain gathers, summed, within
  rtol 1e-5 (the sums run in another order), with a chunk whose output
  reaches no loss, one under `no_grad`, coordinate gradients, and a level
  consumer that is not a gather;
* one `tiny` training step allocates (zeroes) each pyramid level's gradient
  once, through the pyramid node, and gives the same gradients as the same
  step with every gather on its own;
* the host's choice of lanes per point.
"""
import numpy as np
import pytest
import torch

from scenerf_tpu_torch import config as C
from scenerf_tpu_torch import rendering as R
from scenerf_tpu_torch.data.synthetic import make_batch
from scenerf_tpu_torch.model import SceneRF
from scenerf_tpu_torch.ops import gather as G
from scenerf_tpu_torch.ops.gather import (gather_levels, gather_levels_plain, lanes_per_point,
                                          share_pyramid_grads)
from scenerf_tpu_torch.train import Trainer

torch.set_num_threads(1)
RTOL = 1e-5
TINY_WIDTHS = (2, 4, 8, 16, 32)


def _pyramid(rng, widths=TINY_WIDTHS):
    sphere = C.tiny().sphere
    return [torch.tensor(rng.normal(size=(*R.pyramid_level_size(sphere, s), c)),
                         dtype=torch.float32)
            for s, c in zip(R.SCALES, widths)]


def _coords(rng, levels, n):
    ix = np.stack([rng.uniform(-2.5, lv.shape[1] + 1.5, n) for lv in levels])
    iy = np.stack([rng.uniform(-2.5, lv.shape[0] + 1.5, n) for lv in levels])
    return torch.tensor(ix, dtype=torch.float32), torch.tensor(iy, dtype=torch.float32)


def _close(got, want):
    scale = max(float(want.abs().max()), 1e-3)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=1e-6 * scale)


@pytest.mark.parametrize("seed", [0, 1])
def test_shared_pyramid_grads_match_plain_sum(seed):
    rng = np.random.default_rng(seed)
    levels = _pyramid(rng)
    chunks = [_coords(rng, levels, n) for n in (40, 7, 40, 25, 13)]
    cots = [torch.tensor(rng.normal(size=(c[0].shape[1], sum(TINY_WIDTHS))),
                         dtype=torch.float32) for c in chunks]
    w_lv0 = torch.tensor(rng.normal(size=levels[0].shape), dtype=torch.float32)
    # chunk 1: output reaches no loss; chunk 2: under no_grad; chunk 3: coords
    # that need a gradient; level 0 also feeds a loss term directly

    def run(shared: bool):
        leaves = [lv.clone().requires_grad_(True) for lv in levels]
        xy3 = [t.clone().requires_grad_(True) for t in chunks[3]]
        pyramid, grads = share_pyramid_grads(leaves) if shared else (leaves, None)
        assert (grads is not None) == shared
        loss = (pyramid[0] * w_lv0).sum()
        for i, (ix, iy) in enumerate(chunks):
            if i == 3:
                ix, iy = xy3
            if i == 2:
                with torch.no_grad():
                    out = gather_levels(pyramid, ix, iy, grads=grads)
                assert out.grad_fn is None
                continue
            out = gather_levels(pyramid, ix, iy, grads=grads)
            if i != 1:
                loss = loss + (out * cots[i]).sum()
        loss.backward()
        return [lv.grad for lv in leaves], [t.grad for t in xy3], grads

    got, got_xy, grads = run(shared=True)
    want, want_xy, _ = run(shared=False)
    for a, b in zip(got, want):
        _close(a, b)
    for a, b in zip(got_xy, want_xy):
        _close(a, b)
    assert grads.buffers.take() is None  # the pyramid node took the buffers


def test_shared_pyramid_grads_without_gradient():
    rng = np.random.default_rng(3)
    levels = _pyramid(rng)
    assert share_pyramid_grads(levels)[1] is None  # no level requires a gradient
    leaves = [lv.requires_grad_(True) for lv in levels]
    with torch.no_grad():
        pyramid, grads = share_pyramid_grads(leaves)
    assert grads is None and all(a is b for a, b in zip(pyramid, leaves))
    pyramid, grads = share_pyramid_grads(leaves)
    ix, iy = _coords(rng, levels, 5)
    with pytest.raises(ValueError, match="another pyramid"):
        gather_levels(leaves, ix, iy, grads=grads)
    torch.testing.assert_close(gather_levels(pyramid, ix, iy, grads=grads),
                               gather_levels_plain(levels, ix, iy), rtol=0, atol=0)


def test_training_step_zeroes_each_level_once(monkeypatch):
    """A `tiny` 2-source step: one allocation of the pyramid's buffers, and
    the gradients of the same step with every gather on its own."""
    cfg = C.tiny()
    torch.manual_seed(0)
    model = SceneRF(cfg)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    batch = make_batch(cfg, seed=1)
    noise = model.draw_noise(1, cfg.n_sources, torch.Generator().manual_seed(4), "cpu")
    allocations = []
    get = G._GradBuffers.get

    def counting_get(self):
        if self._buffers is None:
            allocations.append(len(self._like))
        return get(self)

    monkeypatch.setattr(G._GradBuffers, "get", counting_get)
    trainer = Trainer(cfg, device="cpu", model=model)
    got = trainer.train_step(batch, noise=noise)
    shared_grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    assert allocations == [5], allocations  # batch of 1: one pyramid, once

    model.load_state_dict(state)
    monkeypatch.setattr("scenerf_tpu_torch.model.share_pyramid_grads",
                        lambda levels: (tuple(levels), None))
    want = Trainer(cfg, device="cpu", model=model).train_step(batch, noise=noise)
    assert allocations == [5]
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-7, msg=k)
    scale = max(float(g.norm()) for g in shared_grads.values())
    for n, p in model.named_parameters():
        diff = float((shared_grads[n] - p.grad).norm())
        assert diff <= 1e-4 * float(p.grad.norm()) + 1e-6 * scale, (n, diff)


@pytest.mark.parametrize("widths,lanes", [
    ((3,), 1), ((8,), 2), ((32,), 8), ((48,), 16), ((80,), 32), ((1280,), 32),
    (TINY_WIDTHS, 8), ((80, 160, 320, 640, 1280), 32), ((224,), 32), ((2560,), 32),
    ((1,), 1), ((5, 12, 7), 4)])
def test_lanes_per_point(widths, lanes):
    """By width (enough points); a launch of few points widens its groups
    until it runs MIN_WARPS warps: the 1,200-pixel reprojection gather takes
    32 lanes per point, the s1 resample's 678,000 cells keep 1."""
    assert lanes_per_point(widths) == lanes
    assert lanes_per_point(widths, 10**7) == lanes
    few = -(-G.MIN_WARPS * 32 // lanes) - 1  # one point short of MIN_WARPS warps
    assert lanes_per_point(widths, few) == min(2 * lanes, 32)


@pytest.mark.parametrize("n,widths,lanes,rounds", [
    (1200, (3,), 32, 1), (678000, (3,), 1, 1), (169500, (32,), 8, 1),
    (320000, (80, 160, 320, 640, 1280), 32, 4), (65536, (80, 160, 320, 640, 1280), 32, 1),
    (19200, (80, 160, 320, 640, 1280), 32, 1), (1200, (80, 160, 320, 640, 1280), 32, 1)])
def test_lanes_and_rounds_at_kitti_launches(n, widths, lanes, rounds):
    assert lanes_per_point(widths, n) == lanes
    assert G.rounds_per_warp(n, lanes) == rounds
