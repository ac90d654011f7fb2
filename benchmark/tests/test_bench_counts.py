"""The counts of benchmark/counts/ against hand calculation, at the kitti
and bundlefusion shapes (the reference model on the meta device)."""
import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counts import gather, model_flops, norm, peaks

BENCH = Path(__file__).resolve().parents[1]


def conf(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def cfg_of(name):
    from benchmark.drivers.train import reference_config

    return reference_config(conf(name))


def field_flops(d_in, d_latent, d_hidden, n_blocks, d_out):
    """2 per multiply-add of ResnetFC's products: lin_in, the concatenated
    lin_z, two linears a block, lin_out."""
    macs = (d_in * d_hidden + d_latent * n_blocks * d_hidden
            + n_blocks * 2 * d_hidden * d_hidden + d_hidden * d_out)
    return 2 * macs


@pytest.mark.parametrize("name", ["kitti", "bundlefusion"])
def test_field_flops_per_point(name):
    cfg = cfg_of(name)
    rad, gauss = model_flops.field_per_point(conf(name))
    assert rad == field_flops(cfg.d_in, 2480, 512, 3, 4) == 10_811_392
    assert gauss == field_flops(cfg.d_in, 2480, 512, 3, 2)


@pytest.mark.parametrize("name,rays", [("kitti", 185 * 610), ("bundlefusion", 240 * 320)])
def test_pose_flops(name, rays):
    cfg = cfg_of(name)
    rad, gauss = model_flops.field_per_point(conf(name))
    assert model_flops.render(conf(name), cfg, rays) == rays * (64 * rad + 4 * gauss)


@pytest.mark.parametrize("name", ["kitti", "bundlefusion"])
def test_train_step_flops(name):
    c, cfg = conf(name), cfg_of(name)
    enc = model_flops.encoder(c)["flops"]
    rad, gauss = model_flops.field_per_point(c)
    per_ray = 64 * rad + 4 * gauss
    want = 3 * enc + cfg.n_sources * (3 * cfg.n_rays + cfg.n_gt_depth) * per_ray
    assert model_flops.train_step(c, cfg) == want


def test_encoder_sites_and_resamples_at_b7():
    enc = model_flops.encoder(conf("kitti"))
    assert len(enc["bn_sites"]) == 192  # EfficientNet-B7's and the decoder's
    # the five taps and the 1x1-projected bottleneck, each onto its sphere level
    assert [n for n, _ in enc["sphere_gathers"]] == [
        452 * 1500, 226 * 750, 113 * 375, 56 * 188, 28 * 94, 14 * 47]
    assert 3.0e12 < enc["flops"] < 4.0e12


def test_a_conv_counts_by_hand():
    conv = torch.nn.Conv2d(64, 128, 3, padding=1, device="meta")
    with FlopCounterMode(display=False) as fc:
        conv(torch.empty(1, 64, 20, 30, device="meta"))
    assert fc.get_total_flops() == 2 * 128 * 20 * 30 * 64 * 9


def test_gather_bytes_by_hand():
    b, o = gather.gather_work(1000, 2480, 2, 5)
    assert b == 1000 * 2480 * 2 + 2 * 4 * 5 * 1000
    assert o == 9 * 1000 * 2480
    cfg = cfg_of("kitti")
    assert gather.render_points(cfg, 1200) == 1200 * 68
    pose = gather.pose_s(cfg, 2480, 100, 2)
    assert pose == pytest.approx((100 * 68 * 2480 * 2 + 40 * 100 * 68) / peaks.HBM_BYTES_PER_S)


def test_gather_step_sums_its_pieces():
    cfg = cfg_of("kitti")
    enc = model_flops.encoder(conf("kitti"))
    step = gather.train_step_s(cfg, 2480, enc["sphere_gathers"], 2)
    pieces = (gather.encode_s(enc["sphere_gathers"], 2)
              + 4 * (gather.pose_s(cfg, 2480, 1200, 2) + gather.pose_s(cfg, 2480, 256, 2)
                     + 3 * peaks.bound_s(*gather.gather_work(1200, 3, 4, 1))))
    assert step == pytest.approx(pieces)


def test_norm_site_by_hand():
    n = 1000 * 64
    t = norm.site_s(1000, 64, "silu", True, 2)
    fwd = max(3 * 2 * n / peaks.HBM_BYTES_PER_S, 11 * n / peaks.F32_FLOPS)
    bwd = max(5 * 2 * n / peaks.HBM_BYTES_PER_S, 25 * n / peaks.F32_FLOPS)
    assert t == pytest.approx(fwd + bwd)
    t = norm.site_s(1000, 64, "identity", False, 4)
    assert t == pytest.approx(2 * 4 * n / peaks.HBM_BYTES_PER_S + 3 * 4 * n / peaks.HBM_BYTES_PER_S)


def test_peaks():
    assert peaks.flops("bfloat16") == 989e12 and peaks.flops("float32") == 67e12
