"""One rank of tests/test_torch_parallel.py: run under torch.distributed
(gloo, on the CPU) with RANK / WORLD_SIZE / MASTER_* in the environment,

    python tests/_torch_parallel_worker.py DIR

it reads DIR/inputs.pt (written by the test's fixture), runs every
multi-rank path of the port on it and writes DIR/rank{r}.pt. Imports torch
and the port only (no JAX)."""
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
torch.set_num_threads(1)

from click.testing import CliRunner  # noqa: E402

from scenerf_tpu_torch import config as C  # noqa: E402
from scenerf_tpu_torch.cli import evaluation as E  # noqa: E402
from scenerf_tpu_torch.cli import reconstruction as RC  # noqa: E402
from scenerf_tpu_torch.cli import train as train_cli  # noqa: E402
from scenerf_tpu_torch.model import SceneRF  # noqa: E402
from scenerf_tpu_torch.ops import norm as N  # noqa: E402
from scenerf_tpu_torch.parallel import dist as D  # noqa: E402
from scenerf_tpu_torch.parallel.sharded_render import (make_sharded_pose_sweep,  # noqa: E402
                                                       make_sharded_renderer)
from scenerf_tpu_torch.train import Trainer, rank_seed  # noqa: E402

STEPS_PER_EPOCH = 7


def _np(t):
    return t.detach().cpu().numpy()


def synced_bn(cases, group, r):
    """Each case's synced K5 on this rank's half of x (plain stages, CPU)."""
    out = []
    for c in cases:
        half = c["x"].shape[0] // 2
        sl = slice(r * half, (r + 1) * half)
        x = torch.tensor(c["x"][sl], requires_grad=True)
        res = torch.tensor(c["r"][sl], requires_grad=True) if c["res"] else None
        w = torch.tensor(c["scale"], requires_grad=True)
        b = torch.tensor(c["bias"], requires_grad=True)
        rm, rv = torch.tensor(c["mean"]), torch.tensor(c["var"])
        y = N.batch_norm_act(x, w, b, rm, rv, True, c["mom"], c["eps"], c["act"], res, group)
        y.backward(torch.tensor(c["g"][sl]))
        out.append({"y": _np(y), "mean": _np(rm), "var": _np(rv), "dx": _np(x.grad),
                    "dw": _np(w.grad), "db": _np(b.grad),
                    "dr": None if res is None else _np(res.grad)})
    return out


def model_from(cfg, sd) -> SceneRF:
    model = SceneRF(cfg)
    model.load_state_dict(sd, strict=True)
    return model


def step_record(trainer: Trainer, metrics) -> dict:
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: _np(p.grad) for k, p in trainer.model.named_parameters()},
            "params": {k: _np(p) for k, p in trainer.model.named_parameters()},
            "buffers": {k: _np(b) for k, b in trainer.model.named_buffers()}}


def one_rank_step(cfg, sd, batch, seed) -> dict:
    trainer = Trainer(cfg, device="cpu", steps_per_epoch=STEPS_PER_EPOCH,
                      model=model_from(cfg, sd), seed=seed)
    return step_record(trainer, trainer.train_step(batch))


def main(d: str) -> None:
    world = D.init("cpu")
    r, group = world.rank, world.group
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    cfg = C.tiny()
    sd, seed = inp["state_dict"], inp["seed"]
    out = {"world": (world.rank, world.size, world.backend)}
    out["bn"] = synced_bn(inp["bn"], group, r)

    # data mode: this rank's item of the global batch, the JAX draws of its device
    trainer = Trainer(cfg, device="cpu", steps_per_epoch=STEPS_PER_EPOCH,
                      model=model_from(cfg, sd), group=group, mode="data")
    local = {k: v[r:r + 1] for k, v in inp["batch2"].items()}
    out["data"] = step_record(trainer, trainer.train_step(local, noise=inp["noise_data"][r]))

    # ray_shard: the same item and draws on both ranks, the rays split
    trainer = Trainer(cfg, device="cpu", steps_per_epoch=STEPS_PER_EPOCH,
                      model=model_from(cfg, sd), seed=seed, group=group, mode="ray_shard")
    out["ray_shard"] = step_record(trainer, trainer.train_step(inp["batch1"]))

    # ray_parallel: the same item, each rank its own draws (recorded)
    trainer = Trainer(cfg, device="cpu", steps_per_epoch=STEPS_PER_EPOCH,
                      model=model_from(cfg, sd), seed=seed, group=group,
                      mode="ray_parallel")
    noise = trainer.model.draw_noise(1, cfg.n_sources, trainer.generator, "cpu")
    out["ray_parallel"] = step_record(trainer, trainer.train_step(inp["batch1"], noise=noise))
    out["ray_parallel"]["pixels"] = _np(noise["pixels"])

    # the one-rank references, shared out: rank 0 the unsplit step and its
    # own ray_parallel draws, rank 1 its ray_parallel draws
    out["ref_ray_parallel"] = one_rank_step(cfg, sd, inp["batch1"], rank_seed(seed, r))
    if r == 0:
        out["ref_ray_shard"] = one_rank_step(cfg, sd, inp["batch1"], seed)

    # sharded eval renders against the one-rank renders (rank 0 gathers)
    model = model_from(cfg, sd).eval()
    rd = inp["render"]
    pyramid = model.pyramid_for_item(model.encode(torch.from_numpy(rd["img"]), rd["K"]), 0)
    K, T = torch.from_numpy(rd["K"]), torch.from_numpy(rd["T"])
    pixels = torch.from_numpy(rd["pixels"])
    render = make_sharded_renderer(model, group, rd["chunk"])
    renders = {"jax_noise": render(pyramid, K, T, pixels, None,
                                   noise_uni=torch.from_numpy(rd["nu"]),
                                   noise_gauss=torch.from_numpy(rd["ng"])),
               "generator": render(pyramid, K, T, pixels, torch.Generator().manual_seed(3))}
    sweep = make_sharded_pose_sweep(model, group, stride=rd["stride"], ray_chunk=rd["chunk"])
    renders["sweep"] = sweep(pyramid, K, torch.from_numpy(rd["poses"]), seed=11)
    if r == 0:
        with torch.no_grad():
            one = model.render_rays(pyramid, K, T, pixels, torch.Generator().manual_seed(3),
                                    ray_chunk=rd["chunk"])
        renders["one_generator"] = {k: one[k] for k in ("depth", "color")}
        renders["one_sweep"] = model.render_pose_sweep(
            pyramid, K, torch.from_numpy(rd["poses"]), seed=11, stride=rd["stride"],
            ray_chunk=rd["chunk"])
    out["render"] = {k: None if v is None else {n: _np(t) for n, t in v.items()}
                     for k, v in renders.items()}

    # the CLI's refusals in a world of two ranks
    cli = {}
    for name, group_cli, args in (
            ("save-depth-metrics", E.cli, ["save-depth-metrics", "--n_devices", "3"]),
            ("generate-novel-depths-bf", RC.cli, ["generate-novel-depths-bf", "--n_devices",
                                                  "3"]),
            ("train-kitti", train_cli.cli, ["train-kitti", "--bs", "3"])):
        res = CliRunner().invoke(group_cli, [*args, "--device", "cpu"])
        cli[name] = (res.exit_code, res.output)
    out["cli"] = cli
    torch.save(out, os.path.join(d, f"rank{r}.pt"))
    D.barrier(group)
    D.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
