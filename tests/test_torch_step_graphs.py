"""When a training step replays CUDA graphs (`scenerf_tpu_torch/step_graphs.py`),
checked without a card: on the CPU, and with a process group, every step
runs eagerly and no graph is captured (`graph_capture` and `graph_replay`
count nothing under `tracing.recording()`); the shape key that the graphs
are kept under separates the shapes that must not share a graph and joins
steps that differ only in values. The graphed step itself needs a card:
tests/test_torch_step_graphs_cuda.py.
"""
import pytest
import torch
import torch.distributed as dist

from scenerf_tpu_torch import config as C
from scenerf_tpu_torch.data.synthetic import make_batch
from scenerf_tpu_torch.model import SceneRF
from scenerf_tpu_torch.step_graphs import shape_key
from scenerf_tpu_torch.train import Trainer
from scenerf_tpu_torch.utils import tracing

torch.set_num_threads(1)


@pytest.fixture
def world_of_one():
    """A gloo process group of this process alone."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def graph_counts():
    return [{k: v for k, v in s.counts.items() if k.startswith("graph_")}
            for s in tracing.snapshot() if s.name == "train_step"]


@pytest.mark.parametrize("where", ["cpu", "cpu_group", "card_group"])
def test_no_graph_on_the_cpu_or_with_a_group(where, request):
    """Two steps of one shape (the second would capture on one rank on a
    card) run eagerly. "card_group": a trainer that takes its device for a
    card but has a group asks for no graph (the step itself is not run: no
    card here)."""
    cfg = C.tiny()
    group = request.getfixturevalue("world_of_one") if where.endswith("group") else None
    trainer = Trainer(cfg, device="cpu", seed=0, group=group)
    batch = make_batch(cfg)
    with tracing.recording():
        if where == "card_group":
            trainer.device = torch.device("cuda")
            tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
            noise = trainer.model.draw_noise(1, cfg.n_sources, trainer.generator, "cpu")
            with tracing.span("train_step"):
                assert trainer._step_graphs(tensors, noise, {}) is None
            with tracing.span("train_step"):
                assert trainer._step_graphs(tensors, noise, {}) is None
        else:
            trainer.train_step(batch)
            trainer.train_step(batch)
    assert graph_counts() == [{}, {}]
    assert trainer._graphs == {}


def step_inputs(cfg, items=1, seed=0):
    """A step's batch and draws as the trainer hands them to the model."""
    batch = make_batch(cfg, batch_size=items, seed=seed)
    tensors = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in batch.items()}
    with torch.device("meta"):
        model = SceneRF(cfg)
    noise = model.draw_noise(items, cfg.n_sources, torch.Generator().manual_seed(seed), "cpu")
    return tensors, noise


def half_rays(tensors, noise):
    n = noise["pixels"].shape[2] // 2
    return tensors, {k: v[:, :, :n] if k in ("pixels", "uni", "gauss", "reproj") else v
                     for k, v in noise.items()}


@pytest.mark.parametrize("change, same", [
    ("other_values", True),
    ("half_rays", False),
    ("more_sources", False),
    ("two_items", False),
    ("fewer_gt_rays", False),
    ("bf16_image", False),
])
def test_shape_key_separates_shapes(change, same):
    cfg = C.tiny()
    base = shape_key(*step_inputs(cfg))
    if change == "other_values":
        other = step_inputs(cfg, seed=3)
    elif change == "half_rays":
        other = half_rays(*step_inputs(cfg))
    elif change == "more_sources":
        other = step_inputs(cfg.replace(n_sources=3))
    elif change == "two_items":
        other = step_inputs(cfg, items=2)
    elif change == "fewer_gt_rays":
        other = step_inputs(cfg.replace(n_gt_depth=16))
    else:
        tensors, noise = step_inputs(cfg)
        other = ({**tensors, "img_input": tensors["img_input"].bfloat16()}, noise)
    assert (shape_key(*other) == base) is same
