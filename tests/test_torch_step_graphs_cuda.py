"""The training step's CUDA graphs (`scenerf_tpu_torch/step_graphs.py`) on the
card, at the `tiny` config in f32 and bf16, against the same trainer's steps
run eagerly (`Trainer._eager`, set by checks only) from the same state:
over four steps (the first eager, the second captured, every later one
replayed) the metrics, every parameter's gradient, the parameters after
AdamW, the batch norms' running statistics and AdamW's moments; a shape
change (half of the rays) capturing graphs of its own beside the first;
the probe's patches of `encode`, `pyramid_for_item` and `optimizer.step`
and its hooks on the pyramid views firing on a graphed step with the eager
step's values; the returned `total_loss` tensors keeping their values; a
`state_dict` taken after graphed steps resuming as the run goes on.

Equal means bit-equal where the step is deterministic: the metrics and the
running statistics (the forward), and the parameters of every leaf whose
gradient came out bit-equal. Kernel G-bwd adds into its level gradients
with float atomics, whose order varies from run to run, so two eager steps
from one state differ already: the gradients and AdamW's moments are held
as whole vectors to 1e-4 relative in f32 and 10 x 2^-8 in bf16, the
parameters to 2.5 lr an element (`TOL`, and why). Faults planted in a
two-item step's graphs (an item's inputs not copied in, its backward not
replayed, one pyramid level's gradient left out) fail these limits.

Marked `cuda`; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_step_graphs_cuda.py
"""
import copy
from functools import partial

import pytest
import torch

from scenerf_tpu_torch import config as C
from scenerf_tpu_torch.data.synthetic import make_batch
from scenerf_tpu_torch.model import LEVEL_KEYS, SceneRF
from scenerf_tpu_torch.train import Trainer
from scenerf_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda

DTYPES = ["float32", "bfloat16"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def pair(cfg, dev):
    """A trainer and an eager twin on the same weights, draws and state."""
    torch.manual_seed(0)
    model = SceneRF(cfg)
    graphed = Trainer(cfg, device=dev, model=model, seed=0)
    eager = Trainer(cfg, device=dev, seed=0)
    eager._eager = True
    eager.load_state_dict(copy.deepcopy(graphed.state_dict()))
    return graphed, eager


def half_rays(noise):
    n = noise["pixels"].shape[2] // 2
    return {k: v[:, :, :n] if k in ("pixels", "uni", "gauss", "reproj") else v
            for k, v in noise.items()}


def draws(cfg, dev, seed, half=False):
    with torch.device("meta"):
        model = SceneRF(cfg)
    noise = model.draw_noise(1, cfg.n_sources, torch.Generator().manual_seed(seed), "cpu")
    noise = {k: v.to(dev) for k, v in noise.items()}
    return half_rays(noise) if half else noise


def gap(a: torch.Tensor, b: torch.Tensor, scale: float = 0.0) -> float:
    """|a - b| / max(|b|, scale), in f64."""
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm()) / max(float(b.norm()), scale, 1e-30)


def vector_gap(got: list, want: list) -> float:
    """The gap of the tensors of `got`, laid end to end as one vector, from
    those of `want`, relative to `want`'s (f64)."""
    num = sum(float((a.detach().double() - b.detach().double()).square().sum())
              for a, b in zip(got, want))
    den = sum(float(b.detach().double().square().sum()) for b in want)
    return (num / max(den, 1e-60)) ** 0.5


def state_gaps(got: Trainer, want: Trainer) -> dict:
    """The gaps of two trainers' state after a step from one state: all
    the parameters' gradients as one vector ("grad"), AdamW's two moments
    each as one vector ("adam", the larger), the batch norms' running
    statistics ("buffer", the largest leaf's, relative), the parameters in
    units of lr a element ("param_lr"), and (0 or 1) whether a leaf with
    bit-equal gradients left unequal parameters ("param_unequal"); for the
    record, the largest gap of one leaf's gradient and its leaf."""
    gp, wp = dict(got.model.named_parameters()), dict(want.model.named_parameters())
    lr = want.optimizer.param_groups[0]["lr"]
    names = [n for n, w in wp.items() if w.grad is not None]
    assert names == [n for n, g in gp.items() if g.grad is not None]
    out = {"grad": vector_gap([gp[n].grad for n in names], [wp[n].grad for n in names])}
    moments = []
    for k in ("exp_avg", "exp_avg_sq"):
        have = [n for n in wp if k in want.optimizer.state.get(wp[n], {})]
        assert have == [n for n in gp if k in got.optimizer.state.get(gp[n], {})], k
        moments.append(vector_gap([got.optimizer.state[gp[n]][k] for n in have],
                                  [want.optimizer.state[wp[n]][k] for n in have]))
    out["adam"] = max(moments)
    gb = dict(got.model.named_buffers())
    out["buffer"] = max((gap(gb[n], w) for n, w in want.model.named_buffers()), default=0.0)
    out["param_lr"] = max(float((gp[n] - w).detach().abs().max()) / lr for n, w in wp.items())
    out["param_unequal"] = int(any(torch.equal(gp[n].grad, wp[n].grad)
                                   and not torch.equal(gp[n], wp[n]) for n in names))
    out["leaf_gap"], out["leaf"] = max((gap(gp[n].grad, wp[n].grad), n) for n in names)
    return out


# what a graphed step may differ by from an eager step of the same state. The
# forward is bit-equal. G-bwd adds into its level gradients with float
# atomics whose order varies from run to run. In f32 every leaf's gradient
# moves a little: the gradients as one vector by up to 6e-7, and 1.4e-5 a
# step after a resume (measured). In bf16 most steps come out bit-equal; in
# some, one sum lands on the other side of a bf16 rounding, the encoder
# backward's later bf16 roundings part one after another, and the whole
# gradient moves by a few bf16 roundings (2^-8): up to 1.2e-2 against an
# eager step, and two eager steps up to 1.1e-2 apart (measured, about 100
# steps each). Faults planted in the graphs read 0.16 and more in both
# dtypes (`test_planted_faults_fail_the_comparison`). So the gradients and
# AdamW's moments are held as whole vectors to 1e-4 in f32 and 10 x 2^-8
# (3.9e-2) in bf16, between the two; the parameters to 2.5 lr an element
# (AdamW moves an element by about lr whatever its gradient, so a gradient
# that is rounding alone takes steps of either sign: up to 1.8 lr, measured).
BF16_ROUNDING = 2.0**-8
TOL = {dtype: {"metric": 0.0, "buffer": 0.0, "grad": g, "adam": g, "param_lr": 2.5,
               "param_unequal": 0}
       for dtype, g in (("float32", 1e-4), ("bfloat16", 10 * BF16_ROUNDING))}
# a step after states that differ by such rounding: its forward too (f32: up
# to 1.4e-5 and 1e-5, measured)
TOL_NEXT = {dtype: {**tol, "metric": tol["grad"], "buffer": tol["grad"]}
            for dtype, tol in TOL.items()}


def within(gaps: dict, tol: dict) -> bool:
    return all(gaps[k] <= tol[k] for k in tol)


def graphed_within(counts: list, gaps: list, tol: dict) -> bool:
    """Every graphed step's gaps within `tol`. A step eager on both sides
    is no test of the graphs and is left out."""
    return all(within(g, tol) for c, g in zip(counts, gaps) if c)


def metric_gaps(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    return max(gap(got[k], want[k], 1e-6) for k in want)


def graph_counts(spans) -> list:
    return [{k: v for k, v in s.counts.items() if k.startswith("graph_")}
            for s in spans if s.name == "train_step"]


def step_both(graphed, eager, batch, noise=None):
    """One step of each from the graphed trainer's state (a copy: the
    optimizer's part of `state_dict()` is its live tensors); (the graphed
    step's metrics, its graph counters, the gaps)."""
    eager.load_state_dict(copy.deepcopy(graphed.state_dict()))
    with tracing.recording():
        got = graphed.train_step(batch, noise=noise)
    counts = graph_counts(tracing.snapshot())[0]
    want = eager.train_step(batch, noise=noise)
    torch.cuda.synchronize()
    return got, counts, {"metric": metric_gaps(got, want), **state_gaps(graphed, eager)}


@pytest.mark.parametrize("dtype", DTYPES)
def test_graphed_steps_equal_eager_steps(dev, dtype):
    cfg = C.tiny(compute_dtype=dtype)
    graphed, eager = pair(cfg, dev)
    counts, gaps = [], []
    for i in range(4):
        _, c, g = step_both(graphed, eager, make_batch(cfg, seed=i))
        counts.append(c)
        gaps.append(g)
    print(dtype, gaps)
    assert counts == [{}, {"graph_capture": 1, "graph_replay": 1}, {"graph_replay": 1},
                      {"graph_replay": 1}]
    assert len(graphed._graphs) == 1 and eager._graphs == {}
    assert graphed_within(counts, gaps, TOL[dtype]), gaps


@pytest.mark.parametrize("dtype", DTYPES)
def test_half_of_the_rays_get_graphs_of_their_own(dev, dtype):
    cfg = C.tiny(compute_dtype=dtype)
    graphed, eager = pair(cfg, dev)
    plan = [False, False, True, True, False, True, True, False]  # half of the rays?
    expect = [{}, {"graph_capture": 1, "graph_replay": 1}, {},
              {"graph_capture": 1, "graph_replay": 1}] + [{"graph_replay": 1}] * 4
    counts, gaps = [], []
    for i, half in enumerate(plan):
        _, c, g = step_both(graphed, eager, make_batch(cfg, seed=i), draws(cfg, dev, i, half))
        counts.append(c)
        gaps.append(g)
    print(dtype, gaps)
    assert counts == expect
    assert len(graphed._graphs) == 2 and all(graphed._graphs.values())
    assert graphed_within(counts, gaps, TOL[dtype]), gaps


def plant(graphs, fault: str) -> None:
    """Break item 1's training-render block of a two-item step's `graphs` as
    `fault` says ("none": leave it whole)."""
    block = graphs.render_train[1]
    if fault == "stale_inputs":  # the item's rays and images of the step before
        block.replay_forward = lambda given: graphs.replay(block.fwd_graph)
    elif fault == "stale_backward":  # its backward not replayed: the step before's gradients
        def replay_backward(grads):
            graphs.next += 1
            return [None if g is None else g.detach() for g in block.grad_ins]

        block.replay_backward = replay_backward
    elif fault == "level_dropped":  # no gradient from it reaches the 1_16 level
        whole = block.replay_backward

        def replay_backward(grads):
            out = whole(grads)
            out[LEVEL_KEYS.index("1_16")] = None
            return out

        block.replay_backward = replay_backward


@pytest.mark.parametrize("fault", ["none", "stale_inputs", "stale_backward", "level_dropped"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_planted_faults_fail_the_comparison(dev, dtype, fault):
    """Two items a step, each with render graphs of its own: whole graphs
    hold TOL over three steps (eager, capturing, replaying); a fault planted
    in item 1's graphs once they are captured fails TOL on the next step,
    which replays them. No step is taken from the state a fault leaves (a
    step from it once faulted the device)."""
    cfg = C.tiny(compute_dtype=dtype)
    graphed, eager = pair(cfg, dev)
    counts, gaps = [], []
    for i in range(3):
        if i == 2:
            (graphs,) = graphed._graphs.values()
            assert len(graphs.render_train) == len(graphs.render_gt) == 2
            plant(graphs, fault)
        _, c, g = step_both(graphed, eager, make_batch(cfg, batch_size=2, seed=i))
        counts.append(c)
        gaps.append(g)
    print(dtype, fault, gaps)
    assert counts == [{}, {"graph_capture": 1, "graph_replay": 1}, {"graph_replay": 1}]
    if fault == "none":
        assert graphed_within(counts, gaps, TOL[dtype]), gaps
    else:
        assert not within(gaps[2], TOL[dtype]), gaps[2]


def probe(trainer, batch) -> dict:
    """One step with the benchmark probe's patches: the encoder's output,
    each pyramid view's gradient (a hook on the view), the gradients the
    optimizer gets; the patches removed after."""
    model, opt = trainer.model, trainer.optimizer
    rec = {"levels": {}, "view_grads": {}, "grads": {}, "calls": []}

    def encode(*a, **kw):
        rec["calls"].append("encode")
        levels = type(model).encode(model, *a, **kw)
        rec["levels"].update({k: t.detach().clone() for k, t in levels.items()})
        return levels

    def add(key, g):
        rec["view_grads"][key] = rec["view_grads"].get(key, 0) + g.detach().float()

    def pyramid_for_item(levels, b):
        rec["calls"].append("pyramid_for_item")
        views = type(model).pyramid_for_item(levels, b)
        for i, v in enumerate(views):
            v.register_hook(partial(add, (b, i)))
        return views

    step = opt.step

    def opt_step(*a, **kw):
        rec["calls"].append("optimizer.step")
        rec["grads"] = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                        if p.grad is not None}
        return step(*a, **kw)

    model.encode, model.pyramid_for_item, opt.step = encode, pyramid_for_item, opt_step
    try:
        rec["metrics"] = trainer.train_step(batch)
    finally:
        del model.encode, model.pyramid_for_item
        opt.step = step
    torch.cuda.synchronize()
    return rec


@pytest.mark.parametrize("dtype", DTYPES)
def test_patches_and_hooks_fire_on_a_graphed_step(dev, dtype):
    cfg = C.tiny(compute_dtype=dtype)
    graphed, eager = pair(cfg, dev)
    for i in range(2):
        graphed.train_step(make_batch(cfg, seed=i))
    eager.load_state_dict(copy.deepcopy(graphed.state_dict()))
    with tracing.recording():
        got = probe(graphed, make_batch(cfg, seed=2))
    assert graph_counts(tracing.snapshot()) == [{"graph_replay": 1}]
    want = probe(eager, make_batch(cfg, seed=2))
    assert got["calls"] == want["calls"] == ["encode", "pyramid_for_item", "optimizer.step"]
    tol_grad = TOL[dtype]["grad"]
    for part, tol in (("levels", 0.0), ("view_grads", tol_grad), ("grads", tol_grad)):
        keys = sorted(want[part])
        assert sorted(got[part]) == keys and keys, part
        d = vector_gap([got[part][k] for k in keys], [want[part][k] for k in keys])
        assert d <= tol, (part, d)
    assert metric_gaps(got["metrics"], want["metrics"]) == 0


def test_returned_losses_keep_their_values(dev):
    cfg = C.tiny()
    trainer, _ = pair(cfg, dev)
    returned, read = [], []
    for i in range(4):
        m = trainer.train_step(make_batch(cfg, seed=i))
        returned.append(m)
        read.append({k: v.clone() for k, v in m.items()})
    torch.cuda.synchronize()
    for m, r in zip(returned, read):
        for k in r:
            assert torch.equal(m[k], r[k]), k
    assert len({m["total_loss"].data_ptr() for m in returned}) == 4
    assert len({float(r["total_loss"]) for r in read}) == 4


@pytest.mark.parametrize("dtype", DTYPES)
def test_state_dict_after_graphed_steps_resumes(dev, dtype):
    """Trainer A takes 3 steps (the last two graphed) and its state is
    saved; A goes on for 2 steps, and trainer B, a new one resumed from the
    saved state, takes the same 2 (eager, then captured): B's state equals
    A's bit for bit after the resume, its first step A's within TOL, its
    second within TOL_NEXT (the states it starts from differ by the first
    step's atomics)."""
    cfg = C.tiny(compute_dtype=dtype)
    a, _ = pair(cfg, dev)
    for i in range(3):
        a.train_step(make_batch(cfg, seed=i))
    saved = copy.deepcopy(a.state_dict())
    b = Trainer(cfg, device=dev, seed=5)
    b.load_state_dict(copy.deepcopy(saved))
    resumed = b.state_dict()
    for k, v in saved["model"].items():
        assert torch.equal(resumed["model"][k], v), k
    assert resumed["step"] == saved["step"] and torch.equal(resumed["generator"],
                                                            saved["generator"])
    for i in range(3, 5):
        got_a = a.train_step(make_batch(cfg, seed=i))
        got_b = b.train_step(make_batch(cfg, seed=i))
        torch.cuda.synchronize()
        g = {"metric": metric_gaps(got_b, got_a), **state_gaps(b, a)}
        print(dtype, i, g)
        assert within(g, (TOL if i == 3 else TOL_NEXT)[dtype]), g
    assert len(b._graphs) == 1 and all(b._graphs.values())
