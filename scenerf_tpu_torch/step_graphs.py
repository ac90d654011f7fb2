"""CUDA graphs of a one-rank training step's blocks: captured once per input
shape, replayed on every later step, so the host launches a few graphs a
step where it launched every kernel.

    graphs = StepGraphs(model, tensors, noise, maps)   # captures; runs nothing
    loss, metrics = model(tensors, noise, train=True, sphere_maps=maps, graphs=graphs)
    loss.backward()                                    # replays the backward graphs

The blocks of a step with B items, each a graph of the kernels the eager
step launches there, in the same order:
- the encoder (`net_rgb` in train mode; its batch norms update their
  running statistics in place), forward and backward;
- each item's training renders of all its sources with their losses and
  logs (`SceneRF.render_train_item`, `share_pyramid_grads` inside), forward
  and backward;
- each item's GT-depth renders and depth metrics (`SceneRF.render_gt_item`),
  forward only.
What runs between them stays eager and is reached through the same calls
as on an eager step: the upload, `SceneRF.encode` and `pyramid_for_item`
(whose views of the encoder's output an item's graphs take as inputs), the
sums of the losses over the sources, autograd's accumulation into `.grad`
and the optimizer. A block copies each input into its graph's static twin
unless it lies there already (an item's pyramid views lie in the encoder's
static outputs, so they are never copied), replays, and returns the static
outputs themselves: the next replay overwrites them, so what outlives the
step is computed from them eagerly. Its backward copies the output
gradients in, replays, and returns the graph's gradient buffers; autograd
takes a parameter's buffer as its `.grad` where it has none (so the
trainer's `zero_grad(set_to_none=True)` comes before the next step).

Capture records kernels without running them, so it moves no parameter,
statistic or draw. Every graph of one `StepGraphs` allocates from one
memory pool, in which a graph may reuse what a graph captured before it
left free: so the graphs replay in the order they were captured, which is
the step's own (encoder forward; per item the training, then the GT-depth
render; the items' training backward, last item first; encoder backward).
A replay out of that order raises. The captures run on a stream of their
own.
"""
from __future__ import annotations

import gc
import weakref
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from scenerf_tpu_torch.model import Noise, SceneRF


def shape_key(tensors: Dict[str, torch.Tensor], noise: Noise) -> Tuple:
    """What a step's graphs are captured for: each batch and draw tensor's
    name, shape and dtype. Steps of one key replay one set of graphs."""
    return tuple((k, tuple(v.shape), v.dtype) for part in (tensors, noise)
                 for k, v in sorted(part.items()))


def _flat(tree, key=None) -> List[Tuple[Optional[str], torch.Tensor]]:
    """The tensors of nested dicts, lists and tuples, in order, each with
    the innermost dict key above it."""
    if isinstance(tree, torch.Tensor):
        return [(key, tree)]
    if isinstance(tree, dict):
        return [kt for k, v in tree.items() for kt in _flat(v, k)]
    return [kt for v in tree for kt in _flat(v, key)]


def _rebuild(tree, leaves: Iterator[torch.Tensor]):
    """`tree` with its tensors replaced, in `_flat`'s order, by `leaves`."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    return type(tree)(_rebuild(v, leaves) for v in tree)


def _pairs(static, given) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """(static tensor, given tensor) at each place of the static inputs'
    structure; raises where the given ones differ in structure or shape."""
    if isinstance(static, torch.Tensor):
        if given.shape != static.shape or given.dtype != static.dtype:
            raise ValueError(f"a graph input {given.dtype} {tuple(given.shape)}, captured "
                             f"as {static.dtype} {tuple(static.shape)}")
        yield static, given
        return
    if len(given) != len(static):
        raise ValueError(f"graph inputs of {len(given)} entries, captured with {len(static)}")
    for k in (static.keys() if isinstance(static, dict) else range(len(static))):
        yield from _pairs(static[k], given[k])


class _Replay(torch.autograd.Function):
    """A block's forward graph, and its backward graph as the node's
    backward. Inputs: the block, its given input tensors, its parameters
    (for autograd's edges only)."""

    @staticmethod
    def forward(ctx, block: "_Block", *tensors):
        ctx.block = block
        block.replay_forward(tensors[:block.n_inputs])
        outs = tuple(o.detach() for o in block.outs)
        ctx.mark_non_differentiable(*(o for i, o in enumerate(outs) if i not in block.diff))
        ctx.set_materialize_grads(False)
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        return (None, *ctx.block.replay_backward(grads))


class _Block:
    """One block: `fn(*args)` captured as a forward graph on static `args`
    (tensors in nested dicts, lists and tuples, taken as they are), and,
    by `capture_backward`, the gradients of its outputs as a backward
    graph."""

    def __init__(self, owner: "StepGraphs", fn: Callable, args: Sequence):
        # a weak reference: no cycle, so a dropped trainer's graphs and their
        # pool go at once, and never in a collection during another capture
        self.owner, self.args = weakref.proxy(owner), tuple(args)
        self.inputs = [t for _, t in _flat(self.args)]
        self.n_inputs = len(self.inputs)
        self.out, self.fwd_graph = owner.capture(lambda: fn(*self.args))
        self.outs = [t for _, t in _flat(self.out)]
        self.diff: Tuple[int, ...] = ()
        self.params: List[torch.Tensor] = []

    def capture_backward(self, params: Sequence[torch.Tensor],
                         wrt: Callable[[Optional[str]], bool]) -> None:
        """The backward graph: the gradients of the outputs that need one
        and whose key `wrt` takes, of the inputs that require grad and of
        those of `params` that the block reaches (the block's parameters)."""
        flat = _flat(self.out)
        self.diff = tuple(i for i, (k, o) in enumerate(flat) if o.requires_grad and wrt(k))
        self.grad_outs = [torch.empty_like(self.outs[i]) for i in self.diff]
        wrt_inputs = [t for t in self.inputs if t.requires_grad] + list(params)
        grads, self.bwd_graph = self.owner.capture(lambda: torch.autograd.grad(
            [self.outs[i] for i in self.diff], wrt_inputs, self.grad_outs, allow_unused=True))
        n = sum(t.requires_grad for t in self.inputs)
        used = [i for i, g in enumerate(grads[n:]) if g is not None]
        self.params = [params[i] for i in used]
        it = iter(grads[:n])
        self.grad_ins = ([next(it) if t.requires_grad else None for t in self.inputs]
                         + [grads[n + i] for i in used])
        self.outs = [o.detach() for o in self.outs]  # free the capture's autograd graph
        self.out = _rebuild(self.out, iter(self.outs))

    def __call__(self, *args):
        """The block's outputs for `args` (shaped as the captured ones):
        through autograd where gradients are recorded, else the forward
        graph alone."""
        given = [g for _, g in _pairs(self.args, args)]
        if torch.is_grad_enabled() and self.diff:
            outs = _Replay.apply(self, *given, *self.params)
        else:
            self.replay_forward(given)
            outs = [o.detach() for o in self.outs]
        return _rebuild(self.out, iter(outs))

    def replay_forward(self, given: Sequence[torch.Tensor]) -> None:
        for static, g in zip(self.inputs, given):
            if g.data_ptr() != static.data_ptr():
                static.copy_(g)
        self.owner.replay(self.fwd_graph)

    def replay_backward(self, grads: Sequence[Optional[torch.Tensor]]) -> List:
        for i, static in zip(self.diff, self.grad_outs):
            g = grads[i]
            if g is None:
                static.zero_()
            elif g.data_ptr() != static.data_ptr():
                static.copy_(g)
        self.owner.replay(self.bwd_graph)
        return [None if g is None else g.detach() for g in self.grad_ins]


class StepGraphs:
    """The graphs of a one-rank training step for one `shape_key`, captured
    from the step's device tensors (shapes only: the inputs are copied) on
    the model's device, in train mode. `encoder(img, maps)` stands in for
    `net_rgb`; `render_train[b](pyramid, item)` and
    `render_gt[b](pyramid, item)` for item b's `SceneRF.render_train_item`
    and `render_gt_item` (`item_inputs`' dicts). A capture that fails
    raises."""

    def __init__(self, model: SceneRF, tensors: Dict[str, torch.Tensor], noise: Noise,
                 maps: Dict[int, torch.Tensor]):
        device = tensors["img_input"].device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.sequence: List[torch.cuda.CUDAGraph] = []  # capture order = replay order
        self.next = 0
        model.train(True)
        params = [p for p in model.parameters() if p.requires_grad]
        static = lambda t: t.detach().clone()
        img = static(tensors["img_input"].to(model.cfg.dtype))
        self.encoder = _Block(self, model.net_rgb, (img, {s: static(m) for s, m in maps.items()}))
        B = tensors["img_input"].shape[0]
        self.render_train, self.render_gt = [], []
        for b in range(B):
            pyramid = tuple(lv.detach().requires_grad_(True)
                            for lv in type(model).pyramid_for_item(self.encoder.out, b))
            train, gt = SceneRF.item_inputs(tensors, noise, b, True, True)
            self.render_train.append(_Block(self, model.render_train_item, (
                pyramid, {k: static(v) for k, v in train.items()})))
            self.render_gt.append(_Block(self, model.render_gt_item, (
                tuple(lv.detach() for lv in pyramid), {k: static(v) for k, v in gt.items()})))
        terms = set(model.loss_weights())
        for block in reversed(self.render_train):
            block.capture_backward(params, lambda key: key in terms)
        self.encoder.capture_backward(params, lambda key: True)

    def capture(self, fn: Callable):
        """(fn(), the graph of the kernels it launched), on this step's pool
        and stream, appended to the replay order. The garbage collector is
        off meanwhile: a graph it destroyed (another trainer's, dropped in a
        reference cycle) would end the capture."""
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                out = fn()
        finally:
            if collecting:
                gc.enable()
        self.sequence.append(graph)
        return out, graph

    def replay(self, graph: torch.cuda.CUDAGraph) -> None:
        """Replay `graph`, the next in the capture order (the first starts a
        step); raises on any other."""
        if graph is self.sequence[0]:
            self.next = 0
        if graph is not self.sequence[self.next]:
            raise RuntimeError(f"step graphs replayed out of their capture order: graph "
                               f"{self.sequence.index(graph)} where {self.next} is next")
        graph.replay()
        self.next = (self.next + 1) % len(self.sequence)
