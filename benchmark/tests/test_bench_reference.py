"""The plain reference against the program on the CPU at the `tiny`
preset (the program runs its kernels' plain versions there), from the
weights and draws the benchmark makes; and, on a card, the f32 cells'
control (the reference with TF32 on) failing the cells' limits at the
cells' own sizes."""
import json

import numpy as np
import pytest
import torch

from benchmark.harness import compare, inputs
from benchmark.harness.cell import ROOT, Cell, load_spec
from benchmark.reference import config as RC
from benchmark.reference.model import SceneRF as RefModel
from scenerf_tpu_torch import config as PC
from scenerf_tpu_torch.model import SceneRF

TINY = {"preset": "tiny", "overrides": {"img_size": [64, 48]}, "dtype": "float32",
        "cam_K": [[40.0, 0, 32.0], [0, 40.0, 24.0], [0, 0, 1]],
        "scene": {"depth": [3.0, 8.0], "texture_per_m": 1.0, "source_step": 0.3}}


def both(dtype="float32"):
    cfg = PC.tiny(img_size=(64, 48), compute_dtype=dtype)
    ref = RefModel(RC.tiny(img_size=(64, 48)))
    w = inputs.draw_weights({k: v.shape for k, v in ref.state_dict().items()}, 99, "cpu")
    prog = SceneRF(cfg)
    prog.load_state_dict(w, strict=True)
    ref.load_state_dict(w, strict=True)
    return cfg, prog, ref


def tensors(batch):
    return {k: torch.as_tensor(v, dtype=torch.float32) for k, v in batch.items()}


def test_state_dicts_match():
    _, prog, ref = both()
    a, b = prog.state_dict(), ref.state_dict()
    assert list(a) == list(b) and all(a[k].shape == b[k].shape for k in a)


@pytest.mark.parametrize("dtype,rtol", [("float32", 0.0), ("bfloat16", 0.05)])
def test_training_forward_and_gradients(dtype, rtol):
    cfg, prog, ref = both(dtype)
    batch = tensors(inputs.make_batch(TINY, cfg, 99, 0))
    noise = inputs.draw_noise(cfg, 99, 0, "cpu")
    lp, mp = prog(batch, noise, train=True)
    lp.backward()
    lr, mr = ref(batch, noise, train=True)
    lr.backward()
    assert float(lp) == pytest.approx(float(lr), rel=rtol, abs=0)
    gp = dict(prog.named_parameters())
    gaps = compare.leaf_gaps(
        {k: float(gp[k].grad.norm()) for k, _ in ref.named_parameters()},
        {k: float(p.grad.norm()) for k, p in ref.named_parameters()},
        {k: float(p.grad.norm()) for k, p in ref.named_parameters()})
    if dtype == "float32":
        assert max(gaps.values()) < 1e-6  # summation order of the gather's backward
    else:
        assert float(np.median(list(gaps.values()))) < 0.1


def test_sweep_render_equal_in_f32():
    from benchmark.reference import sampling as RS

    cfg, prog, ref = both()
    prog.eval()
    ref.eval()
    frame = torch.from_numpy(inputs.make_frame(TINY, cfg, 99, 0))
    K = torch.tensor(TINY["cam_K"])
    pose = torch.from_numpy(inputs.sweep_poses(0.5, [0.0, 10.0, -10.0], 1.1)[4])
    pp = prog.pyramid_for_item(prog.encode(frame, K), 0)
    rp = ref.pyramid_for_item(ref.encode(frame, K), 0)
    out = prog.render_image(pp, K, pose, torch.Generator().manual_seed(5), stride=2,
                            ray_chunk=100)
    g = torch.Generator().manual_seed(5)
    pixels, (h, w) = ref._strided_pixels(2, "cpu")
    nu = RS.row_noise(g, pixels.shape[0], cfg.n_pts_uni)
    ng = RS.row_noise(g, pixels.shape[0], cfg.n_pts_gauss, dist="normal")
    with torch.no_grad():
        r = ref.render_rays(rp, K, pose, pixels, ray_chunk=100, noise_uni=nu, noise_gauss=ng)
    assert torch.equal(out["depth"], r["depth"].reshape(h, w))
    assert torch.equal(out["color"], r["color"].reshape(h, w, 3))


def test_inputs_repeat_from_the_seed():
    cfg = PC.tiny(img_size=(64, 48))
    seed = 2 ** 40 + 3
    a, b = inputs.make_batch(TINY, cfg, seed, 1), inputs.make_batch(TINY, cfg, seed, 1)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    c = inputs.make_batch(TINY, cfg, seed + 1, 1)
    assert not np.array_equal(a["img_input"], c["img_input"])
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in c.items()}
    n1, n2 = (inputs.draw_noise(cfg, seed, 0, "cpu") for _ in range(2))
    assert all(torch.equal(n1[k], n2[k]) for k in n1)
    w1 = inputs.draw_weights({"a.weight": (3, 4), "bn.running_var": (4,)}, seed, "cpu")
    assert torch.all(w1["bn.running_var"] > 0) and w1["a.weight"].abs().max() <= 0.5 ** 0.5 * 1.5


def test_sweep_poses_are_the_clis():
    conf = {c["name"]: json.loads((ROOT / c["file"]).read_text())["sweep"]
            for c in load_spec()["configs"]}
    kitti = inputs.sweep_poses(**conf["kitti"])
    bf = inputs.sweep_poses(**conf["bundlefusion"])
    assert kitti.shape == (63, 4, 4) and bf.shape == (33, 4, 4)
    assert kitti[1][0, 2] > 0 and bf[1][0, 2] < 0  # +angle first on KITTI, -angle on BF


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the TF32 control exists only there")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bf-train-f32", "bf-sweep-f32"])
def test_tf32_control_is_not_correct(card, name):
    """The reference with TF32 on, put in the program's place at the cell's
    own size, fails the cell's limits."""
    from benchmark.harness.trace import Brackets

    cell = Cell(load_spec(), name)
    drv = cell.driver().Driver(cell, 2 ** 33 + 29, card)
    drv.setup()
    drv.window(4.0, Brackets())
    drv.release()
    if drv.kind == "train":
        sides = drv.probe_sides("float32")
        nums = compare.train_numbers(drv.reference(lower="float32"), drv.reference())
        nums.update(compare.probe_numbers(sides["control"], sides["ref"]))
        nums.update(compare.adamw_numbers(drv.adamw_norms()))
    else:
        nums = compare.sweep_numbers(drv.pairs(drv.sample(), "float32"))
    assert not compare.verdict(nums, cell.limits), json.dumps(nums)
