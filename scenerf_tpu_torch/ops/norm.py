"""Kernel K5: batch normalization fused with its activation and an optional
residual add (kernels N1-N4 in `csrc/norm.cu`), and its plain PyTorch version.

`batch_norm_act(x, weight, bias, running_mean, running_var, training,
momentum, eps, act, residual)` computes, over a channel-last x [..., C] (f32,
or bf16 on the mixed-precision path; weight, bias and the running statistics
f32 always),

    y = act(x * mul + add (+ residual)),   mul = weight * rsqrt(var + eps),
                                           add = bias - mean * mul

with act one of "identity", "silu" (z * sigmoid(z)) and "leaky" (slope 0.01,
z where z >= 0, so its gradient at 0 is 1 as JAX's `nn.leaky_relu`). In
training mode mean and var are the batch's: f32 `mean` and `mean(x^2)` over
every axis but the last, `var = max(mean2 - mean^2, 0)` (the biased variance;
at a tie the maximum splits the gradient 0.5 / 0.5, as jnp.maximum and
torch.maximum do), and the running statistics move IN PLACE in flax's
convention, `ra = momentum * ra + (1 - momentum) * batch`. In eval mode they
are the running statistics. It replaces the TPU-shaped
`scenerf_tpu/encoder/norm.py:31 FusedBatchNorm` and the activation after it.

On a CPU tensor (or inside `build.plain_versions()` unless it keeps "bn") it runs
`batch_norm_act_plain`, whose autograd saves the pre-activation. On a CUDA
tensor it launches the kernels: forward N1 (statistics, with its finalize)
and N2 (apply; in eval mode alone, folding the running statistics itself),
and, where autograd needs the gradient, `_BatchNormAct`'s backward N3 (the
per-channel sums of g = dy act'(z), z recomputed from x, with its finalize)
and N4 (dx, d_residual). That Function saves x, the residual and the [5, C]
per-channel statistics only. The kernels take an f32 [..., C] tensor that
is contiguous channel-last, or channel-first (a convolution's NCHW output
seen as [B, H, W, C]: the eval encoder's stem gives one), and raise on any
other layout rather than copy it; the outputs take the input's layout.

`plan` picks each launch's path on the host, once per shape: a channel-last
training site whose tiles fit in the shared memory of a thread-block
cluster takes one launch per direction (N1 + N2, or N3 + N4, with the
statistics reduced on chip; counted under both stages' keys and under
`bn_forward_fused` / `bn_backward_fused`); every other launch takes the
streaming kernels, a reduction that finalizes in its last block and then the
elementwise pass. A launch the card refuses raises; nothing falls back.

The stage functions `stats_plain`, `apply_plain`, `bwd_reduce_plain` and
`bwd_apply_plain` are the plain versions of N1-N4 one by one (the same
per-channel [5, C] statistics and [4, C] gradients the kernels pass on);
composed, they give the gradient autograd gives `batch_norm_act_plain`.

Synced batch norm (`batch_norm_act_synced`, a training site of data-parallel
training: JAX's `FusedBatchNorm(axis_name=...)`, which takes the pmean of each
device's mean and mean(x^2)). The cluster path reduces inside one launch and
cannot sync, so a synced site splits each direction at its reduction, on the
card and in the plain version alike:
- forward: this rank's per-channel sums [2, C] of x and x^2 (`sums_plain`;
  on the card N1 without its finalize, `bn_sync_sums`), all-reduced (SUM)
  over the group on the current stream, then the finalize over the world's
  rows (`stats_finalize_plain`, `bn_sync_stats`: the [5, C] statistics and
  the running statistics moved, the same on every rank), then N2;
- backward: this rank's sums of g and g x (`bwd_sums_plain`,
  `bn_sync_bwd_sums`), a copy all-reduced, then the finalize
  (`grads_finalize_plain`, `bn_sync_grads`): dx's alpha and beta from the
  world's sums over the world's rows, dweight and dbias from this rank's own
  sums, then N4. This is JAX's autodiff of the pmean: every rank's loss
  reaches every rank's x through the shared statistics (the transpose of a
  psum is a psum), while each device's parameter gradients are its own
  until the gradient pmean (which the trainer does).
The sums are f64: the streaming reduction's last block adds its partials in
f64, and the synced path hands exactly those numbers on, so at a world of one
rank (`group=None`: no all-reduce) its statistics and gradients are bit-equal
to the streaming path's. 2C f64 per site and direction is 3 KB at the widest
site; the 384 all-reduces of a B7 step are latency, not bytes.

bf16. x, the residual, y and the cotangents dy, dx, d_residual are bf16; the
statistics, mul/add, the parameter gradients and the running statistics f32.
The kernels and the plain versions round at the same points: every bf16
value converts exactly to f32, z = x mul + add (+ r), act(z), g = dy act'(z)
and dx = g mul + alpha + beta x are computed in f32, and y, dx and
d_residual (= g) are each rounded to bf16 once, as they are stored. JAX's
`FusedBatchNorm(dtype=bfloat16)` (`scenerf_tpu/encoder/norm.py:76-78`)
rounds at more points: it casts mul and add to bf16, rounds x * mul and the
sum with add to bf16, then adds the residual and applies the activation in
bf16 (each op rounded), and its autodiff computes dx and the per-channel
sums from bf16 products. So the port's bf16 y sits within one bf16 spacing
of the f32 result, and JAX's within a few.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from scenerf_tpu_torch.ops import build
from scenerf_tpu_torch.parallel import dist as D

ACTS = ("identity", "silu", "leaky")
LEAKY_SLOPE = 0.01
# rows of the per-channel statistics [5, C] N1 writes (in eval mode N2)
MEAN, VAR_RAW, INV, MUL, ADD = range(5)
# rows of the per-channel gradients [4, C] N3's finalize writes
DWEIGHT, DBIAS, ALPHA, BETA = range(4)

# The cluster path's limits on an NVIDIA H100 (csrc/norm.cu refuses a plan
# beyond what the card takes): 512 threads a block, 16 warps; a cluster of at
# most 16 blocks (above 8 the non-portable size); 228 KB of shared memory an
# SM with 1 KB reserved a block, so a block of at most 115,712 bytes leaves
# room for a second one on its SM.
THREADS, WARPS = 512, 16
CLUSTER_MAX = 16
SMEM_PAIR = 115_712
SMS = 132              # the H100's SMs: a cluster plan grows to fill them
SLICE_BYTES = 32       # a cluster's channel slice: one 32-byte sector of each row


class Plan(NamedTuple):
    """A launch's path: "cluster" (one launch a direction), "streaming" or
    "channel-first"; for the cluster path its tiling: blocks a cluster
    (`cluster`), packs of a channel slice (`sv`: 16-byte vectors, or single
    channels on the scalar path), rows a block, shared memory a block
    (bytes), channel slices (clusters in the grid)."""
    path: str
    cluster: int = 0
    sv: int = 0
    rows: int = 0
    smem: int = 0
    slices: int = 0


def cluster_smem(rows: int, sv: int, pack_bytes: int, arrays: int, width: int) -> int:
    """Shared memory of a cluster block (csrc/norm.cu `cluster_layout`):
    `arrays` tiles of rows x sv packs, each rounded up to 16 bytes, then f32
    sums [2, width] and warp sums [WARPS, 2, width] (which later hold the
    coefficients)."""
    tile = -(-rows * sv * pack_bytes // 16) * 16
    return arrays * tile + (2 + 2 * WARPS) * width * 4


@functools.lru_cache(maxsize=4096)
def plan(M: int, C: int, itemsize: int, vector: bool, direction: str, act: str,
         residual: bool, channel_first: bool = False) -> Plan:
    """The path of a training launch of all its stages over [M, C] (x of
    `itemsize` bytes an element; `vector`: 16-byte loads, C a multiple of
    16 / itemsize and every pointer 16-byte aligned). The cluster path where
    a slice's tiles fit in at most CLUSTER_MAX blocks of at most SMEM_PAIR
    bytes: x, and the residual, in the forward; x, dy and, where z needs it,
    the residual in the backward. The cluster is the smallest that fits,
    doubled while the grid has fewer blocks than SMs and each block keeps
    two rows a thread."""
    if channel_first:
        return Plan("channel-first")
    pack = 16 if vector else itemsize
    vw = pack // itemsize
    vectors = C // vw
    sv = min(SLICE_BYTES // pack, 1 << (vectors - 1).bit_length())
    slices = -(-vectors // sv)
    if direction == "forward":
        arrays = 1 + residual
    else:
        arrays = 2 + (residual and act != "identity")
    smem = lambda cs: cluster_smem(-(-M // cs), sv, pack, arrays, sv * vw)  # noqa: E731
    cs = 1
    while cs <= CLUSTER_MAX and smem(cs) > SMEM_PAIR:
        cs *= 2
    if cs > CLUSTER_MAX:
        return Plan("streaming")
    while slices * cs < SMS and cs < CLUSTER_MAX and -(-M // (2 * cs)) >= 2 * THREADS // sv:
        cs *= 2
    return Plan("cluster", cs, sv, -(-M // cs), smem(cs), slices)


def activation(z: torch.Tensor, act: str) -> torch.Tensor:
    """The plain activation; leaky follows JAX at 0 (`where(z >= 0, ...)`)."""
    if act == "silu":
        return F.silu(z)
    if act == "leaky":
        return torch.where(z >= 0, z, LEAKY_SLOPE * z)
    if act == "identity":
        return z
    raise ValueError(f"act must be one of {ACTS}, got {act!r}")


def activation_grad(z: torch.Tensor, act: str) -> torch.Tensor:
    """d act / dz, as N3 and N4 compute it."""
    if act == "silu":
        s = torch.sigmoid(z)
        return s * (1.0 + z * (1.0 - s))
    if act == "leaky":
        return torch.where(z >= 0, torch.ones_like(z), torch.full_like(z, LEAKY_SLOPE))
    return torch.ones_like(z)


def batch_norm_act_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         running_mean: torch.Tensor, running_var: torch.Tensor,
                         training: bool, momentum: float, eps: float, act: str = "identity",
                         residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole op in plain PyTorch ops (see the module docstring)."""
    if training:
        dims = tuple(range(x.dim() - 1))
        xf = x.to(torch.promote_types(x.dtype, torch.float32))  # f32, or f64 for f64
        mean = torch.mean(xf, dim=dims)
        mean2 = torch.mean(torch.square(xf), dim=dims)
        var = torch.maximum(mean2 - torch.square(mean), torch.zeros_like(mean))
        with torch.no_grad():
            running_mean.mul_(momentum).add_((1.0 - momentum) * mean)
            running_var.mul_(momentum).add_((1.0 - momentum) * var)
    else:
        mean, var = running_mean, running_var
    mul = weight * torch.rsqrt(var + eps)
    add = bias - mean * mul
    cd = torch.promote_types(x.dtype, torch.float32)  # bf16 computes in f32
    z = x.to(cd) * mul.to(cd) + add.to(cd)
    if residual is not None:
        z = z + residual.to(cd)
    return activation(z, act).to(x.dtype)


# ---------------------------------------------------------------- stages


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def stats_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                running_mean: torch.Tensor, running_var: torch.Tensor, momentum: float,
                eps: float) -> torch.Tensor:
    """N1 and its finalize: the [5, C] statistics (mean, mean2 - mean^2,
    rsqrt(var + eps), mul, add) of the batch; the running statistics move in
    place."""
    xf = _rows(x).to(torch.float32)
    mean = xf.mean(0)
    var_raw = torch.square(xf).mean(0) - torch.square(mean)
    var = torch.clamp(var_raw, min=0.0)
    inv = torch.rsqrt(var + eps)
    mul = weight * inv
    running_mean.mul_(momentum).add_((1.0 - momentum) * mean)
    running_var.mul_(momentum).add_((1.0 - momentum) * var)
    return torch.stack([mean, var_raw, inv, mul, bias - mean * mul])


def sums_plain(x: torch.Tensor) -> torch.Tensor:
    """The synced N1's reduction: [2, C] f64 sums of x and x^2 over the
    rows."""
    xr = _rows(x).double()
    return torch.stack([xr.sum(0), (xr * xr).sum(0)])


def stats_finalize_plain(sums: torch.Tensor, M: int, weight: torch.Tensor, bias: torch.Tensor,
                         running_mean: torch.Tensor, running_var: torch.Tensor, momentum: float,
                         eps: float) -> torch.Tensor:
    """The synced N1's finalize: the [5, C] statistics of M rows from their
    sums [2, C]; the running statistics move in place."""
    mean = (sums[0] / M).float()
    var_raw = (sums[1] / M).float() - torch.square(mean)
    var = torch.clamp(var_raw, min=0.0)
    inv = torch.rsqrt(var + eps)
    mul = weight * inv
    running_mean.mul_(momentum).add_((1.0 - momentum) * mean)
    running_var.mul_(momentum).add_((1.0 - momentum) * var)
    return torch.stack([mean, var_raw, inv, mul, bias - mean * mul])


def fold_plain(weight: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
               running_var: torch.Tensor, eps: float) -> torch.Tensor:
    """The [5, C] statistics of eval mode, folded from the running ones (N2
    writes them when autograd needs them)."""
    inv = torch.rsqrt(running_var + eps)
    mul = weight * inv
    return torch.stack([running_mean, running_var, inv, mul, bias - running_mean * mul])


def _pre_activation(x, stats, residual):
    """z in f32 (a bf16 x and residual convert exactly) or wider."""
    cd = torch.promote_types(x.dtype, stats.dtype)
    z = x.to(cd) * stats[MUL] + stats[ADD]
    return z if residual is None else z + residual.to(cd)


def apply_plain(x: torch.Tensor, stats: torch.Tensor, act: str,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """N2: act(x * mul + add (+ residual)), rounded to x's dtype."""
    return activation(_pre_activation(x, stats, residual), act).to(x.dtype)


def bwd_sums_plain(x: torch.Tensor, dy: torch.Tensor, stats: torch.Tensor, act: str,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The synced N3's reduction: [2, C] f64 sums of g and g x, g = dy
    act'(z)."""
    g = _rows(dy * activation_grad(_pre_activation(x, stats, residual), act)).double()
    return torch.stack([g.sum(0), (g * _rows(x).double()).sum(0)])


def grads_finalize_plain(local: torch.Tensor, world: torch.Tensor, M: int, stats: torch.Tensor,
                         weight: torch.Tensor, eps: float, training: bool = True) -> torch.Tensor:
    """N3's finalize: the [4, C] gradients, dweight and dbias from the sums
    `local` [2, C] (sum g, sum g x), dx's alpha and beta from the sums
    `world` over M rows (the same sums where nothing is synced)."""
    st = stats.double()
    sg, sgx = world[0], world[1]
    alpha = torch.zeros_like(sg)
    beta = torch.zeros_like(sg)
    if training:
        dmul = sgx - st[MEAN] * sg
        var_raw = st[VAR_RAW]
        var = torch.clamp(var_raw, min=0.0)
        dvar = dmul * weight.double() * (-0.5 * st[INV] / (var + eps))
        share = torch.where(var_raw > 0, 1.0, torch.where(var_raw == 0, 0.5, 0.0))
        dvar_raw = dvar * share
        alpha = (-st[MUL] * sg - 2.0 * st[MEAN] * dvar_raw) / M
        beta = 2.0 * dvar_raw / M
    dweight = (local[1] - st[MEAN] * local[0]) * st[INV]
    return torch.stack([dweight, local[0], alpha, beta]).float()


def bwd_reduce_plain(x: torch.Tensor, dy: torch.Tensor, stats: torch.Tensor,
                     weight: torch.Tensor, eps: float, act: str, training: bool,
                     residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """N3 and its finalize: the [4, C] gradients (dweight, dbias, and dx's
    alpha and beta), from sum g and sum g x with g = dy act'(z)."""
    sums = bwd_sums_plain(x, dy, stats, act, residual)
    return grads_finalize_plain(sums, sums, x.numel() // x.shape[-1], stats, weight, eps,
                                training)


def bwd_apply_plain(x: torch.Tensor, dy: torch.Tensor, stats: torch.Tensor,
                    grads: torch.Tensor, act: str, residual: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """N4: (dx = g mul + alpha + beta x, d_residual = g), rounded to x's
    dtype."""
    z = _pre_activation(x, stats, residual)
    g = dy.to(z.dtype) * activation_grad(z, act)
    dx = g * stats[MUL] + grads[ALPHA] + grads[BETA] * x.to(z.dtype)
    return dx.to(x.dtype), g.to(x.dtype)


def kink_ties(x: torch.Tensor, stats: torch.Tensor, act: str,
              residual: Optional[torch.Tensor] = None, spacings: float = 8.0) -> torch.Tensor:
    """Bool mask of the elements whose pre-activation z (from `stats`) lies
    within `spacings` f32 spacings of the summands |x mul| + |add| + |r| of
    the leaky-ReLU's kink at 0. There two implementations whose statistics
    differ in the last bits may take different slopes, and their gradients
    then differ by (1 - 0.01) dy at that element; with a smooth activation
    the mask is empty."""
    if act != "leaky":
        return torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    summands = (x.float() * stats[MUL]).abs() + stats[ADD].abs()
    if residual is not None:
        summands = summands + residual.float().abs()
    spacing = torch.nextafter(summands, torch.full_like(summands, float("inf"))) - summands
    return _pre_activation(x, stats, residual).abs() <= spacings * spacing


# ---------------------------------------------------------------- kernels

_work = {}  # (device index, stream) -> f32 scratch of the streaming reductions
cotangent_copies = 0  # backward launches whose cotangent was not contiguous


def _workspace(device: torch.device, stream: int, need: int) -> torch.Tensor:
    """The streaming reductions' scratch of at least `need` floats (the
    library's `scenerf_bn_work_floats`: tickets, then partials), reused by
    every launch on one stream (launches on a stream run in order, so one
    buffer serves them). Zeroed when allocated: each launch leaves its
    tickets at 0."""
    key = (device.index, stream)
    buf = _work.get(key)
    if buf is None or buf.numel() < need:
        buf = torch.zeros(need, dtype=torch.float32, device=device)
        _work[key] = buf
        while len(_work) > 4:  # streams come and go (CUDA graph captures): keep the newest
            del _work[next(iter(_work))]
    return buf


def _vector(x: torch.Tensor, layout: Optional[int], *tensors: Optional[torch.Tensor]) -> bool:
    """The kernels' 16-byte loads: channel-last, C a multiple of the vector
    width and every pointer 16-byte aligned."""
    return (not layout and x.shape[-1] % (16 // x.element_size()) == 0
            and all(t is None or t.data_ptr() % 16 == 0 for t in (x, *tensors)))


def launch_path(x: torch.Tensor, direction: str, act: str,
                residual: Optional[torch.Tensor] = None, training: bool = True,
                stages: int = 3, *outputs: Optional[torch.Tensor]) -> Plan:
    """The path a launch over x takes (`plan` for a training launch of both
    stages; the streaming or channel-first kernels else); `outputs` (y, or
    dy, dx, d_residual) count for the vector loads' alignment."""
    layout = plane(x)
    if not training or stages != 3:
        return Plan("channel-first" if layout else "streaming")
    return plan(x.numel() // x.shape[-1], x.shape[-1], x.element_size(),
                _vector(x, layout, residual, *outputs), direction, act, residual is not None,
                bool(layout))


def _plan_args(p: Plan) -> tuple:
    """The entries' cluster, sv, rows and smem arguments (0: streaming)."""
    if p.path != "cluster":
        return 0, 0, 0, 0
    return p.cluster, p.sv, p.rows, p.smem


def _work_for(x: torch.Tensor, layout: int, vector: bool, stream: int) -> torch.Tensor:
    need = build.library().scenerf_bn_work_floats(x.numel() // x.shape[-1], x.shape[-1],
                                                  layout, x.element_size(), int(vector))
    if need < 0:
        raise ValueError(f"batch_norm_act kernel: no workspace for {tuple(x.shape)}")
    return _workspace(x.device, stream, need)


def plane(t: torch.Tensor) -> Optional[int]:
    """The kernels' layout of a [..., C] tensor: 0 for contiguous channel-last,
    the positions per channel plane for channel-first ([B, H, W, C] whose
    permute to [B, C, H, W] is contiguous: a convolution's NCHW output seen
    channel-last), None for any other."""
    if t.is_contiguous():
        return 0
    if t.dim() >= 3 and t.movedim(-1, 1).is_contiguous():
        return t[0, ..., 0].numel()
    return None


# the element types the kernels are instantiated for, and their entries' suffix
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _entry(x: torch.Tensor, direction: str):
    """The library entry of `direction` for x's element type."""
    return getattr(build.library(), f"scenerf_bn_{direction}_{DTYPES[x.dtype]}")


def _check(x: torch.Tensor, residual: Optional[torch.Tensor], *vectors: torch.Tensor) -> int:
    """Raise on what the kernels do not take; the layout (`plane`)."""
    layout = plane(x) if x.dim() >= 1 else None
    if x.dtype not in DTYPES or layout is None:
        raise ValueError(f"batch_norm_act kernel takes an f32 or bf16 tensor, contiguous "
                         f"channel-last or channel-first; got {x.dtype} {tuple(x.shape)} "
                         f"strides {x.stride()}")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype
                                 or plane(residual) != layout
                                 or residual.device != x.device):
        raise ValueError("batch_norm_act kernel: the residual must be a tensor of x's dtype, "
                         "shape, layout and device")
    for v in vectors:
        if (v.dtype != torch.float32 or v.shape != x.shape[-1:] or not v.is_contiguous()
                or v.device != x.device):
            raise ValueError(f"batch_norm_act kernel: per-channel vectors must be contiguous "
                             f"f32 [{x.shape[-1]}] on {x.device}")
    return layout


def launch_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   running_mean: torch.Tensor, running_var: torch.Tensor, training: bool,
                   momentum: float, eps: float, act: str,
                   residual: Optional[torch.Tensor] = None, want_stats: bool = True,
                   stages: int = 3, y: Optional[torch.Tensor] = None,
                   stats: Optional[torch.Tensor] = None):
    """Launch N1 (training, stage bit 0) and N2 (stage bit 1): (y, stats),
    stats [5, C] None in eval mode unless `want_stats`. `y` and `stats` may
    be given (a later stage reuses an earlier one's)."""
    layout = _check(x, residual, weight, bias, running_mean, running_var)
    C = x.shape[-1]
    dev = x.device
    stream = build.stream_handle(dev)
    if y is None:
        y = torch.empty_like(x)
    if stats is None and (training or want_stats):
        stats = torch.empty((5, C), dtype=torch.float32, device=dev)
    vector = _vector(x, layout, residual, y)
    p = launch_path(x, "forward", act, residual, training, stages, y)
    work = (_work_for(x, layout, vector, stream)
            if p.path != "cluster" and training and stages & 1 else None)
    status = _entry(x, "forward")(
        x.data_ptr(), build.ptr(residual), y.data_ptr(), x.numel() // C, C, layout,
        weight.data_ptr(),
        bias.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(), build.ptr(stats),
        build.ptr(work), 0 if work is None else work.numel(), momentum, 1.0 - momentum, eps,
        ACTS.index(act), int(training), stages, *_plan_args(p), stream)
    build.check(status, "batch_norm_act forward")
    if training and stages & 1:
        build.count_launch("bn_stats", x.dtype)
    if stages & 2:
        build.count_launch("bn_apply", x.dtype)
    if p.path == "cluster":
        build.count_launch("bn_forward_fused", x.dtype)
    return y, stats


def launch_backward(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor,
                    stats: torch.Tensor, training: bool, eps: float, act: str,
                    residual: Optional[torch.Tensor] = None, residual_grad: bool = False,
                    stages: int = 3, grads: Optional[torch.Tensor] = None,
                    dx: Optional[torch.Tensor] = None, d_res: Optional[torch.Tensor] = None):
    """Launch N3 (stage bit 0) and N4 (stage bit 1) for the cotangent dy:
    (dx, grads [4, C], d_residual). d_residual is None unless
    `residual_grad`; with the identity it is dy itself (no pass writes it).
    `grads`, `dx` and `d_res` may be given (a later stage reuses an earlier
    one's grads)."""
    C = x.shape[-1]
    dev = x.device
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != dev:
        raise ValueError(f"batch_norm_act backward: cotangent {dy.dtype} {tuple(dy.shape)} "
                         f"for x {x.dtype} {tuple(x.shape)}")
    layout = plane(x)
    if layout is None or x.dtype not in DTYPES:
        raise ValueError(f"batch_norm_act backward: x {x.dtype} of strides {x.stride()}")
    if plane(dy) != layout:
        # autograd's cotangents (an expanded ones_like, a slice) vary: dy takes x's layout
        global cotangent_copies
        cotangent_copies += 1
        dy = torch.empty_like(x).copy_(dy)
    stream = build.stream_handle(dev)
    if dx is None:
        dx = torch.empty_like(x)
    if grads is None:
        grads = torch.empty((4, C), dtype=torch.float32, device=dev)
    if not residual_grad:
        d_res = None
    elif act == "identity":
        d_res = dy
    elif d_res is None:
        d_res = torch.empty_like(x)
    write_res = d_res is not None and act != "identity"
    dres_out = d_res if write_res else None
    vector = _vector(x, layout, residual, dy, dx, dres_out)
    p = launch_path(x, "backward", act, residual, True, stages, dy, dx, dres_out)
    work = _work_for(x, layout, vector, stream) if p.path != "cluster" and stages & 1 else None
    status = _entry(x, "backward")(
        x.data_ptr(), build.ptr(residual), dy.data_ptr(), dx.data_ptr(), build.ptr(dres_out),
        x.numel() // C, C, layout, weight.data_ptr(), stats.data_ptr(), grads.data_ptr(),
        build.ptr(work), 0 if work is None else work.numel(), eps, ACTS.index(act),
        int(training), stages, *_plan_args(p), stream)
    build.check(status, "batch_norm_act backward")
    if stages & 1:
        build.count_launch("bn_bwd_reduce", x.dtype)
    if stages & 2:
        build.count_launch("bn_bwd_apply", x.dtype)
    if p.path == "cluster":
        build.count_launch("bn_backward_fused", x.dtype)
    return dx, grads, d_res


class _BatchNormAct(torch.autograd.Function):
    """N1 + N2 forward, N3 + N4 backward. Saves x, the residual and the
    per-channel statistics (no pre-activation)."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, running, training, momentum, eps, act):
        y, stats = launch_forward(x, weight, bias, running[0], running[1], training,
                                  momentum, eps, act, residual)
        ctx.save_for_backward(x, residual, weight, stats)
        ctx.args = (training, eps, act)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, residual, weight, stats = ctx.saved_tensors
        training, eps, act = ctx.args
        dx, grads, d_res = launch_backward(x, dy, weight, stats, training, eps, act, residual,
                                           residual_grad=ctx.needs_input_grad[3])
        return dx, grads[DWEIGHT], grads[DBIAS], d_res, None, None, None, None, None


# ---------------------------------------------------------------- synced

sync_all_reduces = 0  # all-reduces of the synced path (two a site and step)


def _all_reduce(sums: torch.Tensor, group) -> torch.Tensor:
    """SUM over the group, in place, on the current stream (None: a world of
    one rank, the identity)."""
    global sync_all_reduces
    if group is not None:
        D.all_reduce_sum(sums, group)
        sync_all_reduces += 1
    return sums


def _sync_work(x: torch.Tensor, layout: int, *tensors) -> Tuple[torch.Tensor, int]:
    stream = build.stream_handle(x.device)
    return _work_for(x, layout, _vector(x, layout, *tensors), stream), stream


def launch_sums(x: torch.Tensor) -> torch.Tensor:
    """The synced N1's reduction on the card: [2, C] f64 sums of x and x^2."""
    layout = _check(x, None)
    sums = torch.empty((2, x.shape[-1]), dtype=torch.float64, device=x.device)
    work, stream = _sync_work(x, layout)
    status = getattr(build.library(), f"scenerf_bn_sums_{DTYPES[x.dtype]}")(
        x.data_ptr(), x.numel() // x.shape[-1], x.shape[-1], layout, sums.data_ptr(),
        work.data_ptr(), work.numel(), stream)
    build.check(status, "batch_norm_act synced sums")
    build.count_launch("bn_sync_sums", x.dtype)
    return sums


def launch_stats_finalize(sums: torch.Tensor, M: int, x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, running_mean: torch.Tensor,
                          running_var: torch.Tensor, momentum: float, eps: float) -> torch.Tensor:
    """The synced N1's finalize on the card (`stats_finalize_plain`); x names
    the site's dtype for the launch count."""
    C = sums.shape[1]
    _check(x, None, weight, bias, running_mean, running_var)
    stats = torch.empty((5, C), dtype=torch.float32, device=sums.device)
    status = build.library().scenerf_bn_stats_finalize(
        sums.data_ptr(), M, C, weight.data_ptr(), bias.data_ptr(), running_mean.data_ptr(),
        running_var.data_ptr(), stats.data_ptr(), momentum, 1.0 - momentum, eps,
        build.stream_handle(sums.device))
    build.check(status, "batch_norm_act synced statistics")
    build.count_launch("bn_sync_stats", x.dtype)
    return stats


def launch_bwd_sums(x: torch.Tensor, dy: torch.Tensor, stats: torch.Tensor, act: str,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The synced N3's reduction on the card: [2, C] f64 sums of g and g x."""
    layout = _check(x, residual)
    if dy.shape != x.shape or dy.dtype != x.dtype or plane(dy) != layout:
        raise ValueError(f"batch_norm_act synced backward: cotangent {dy.dtype} "
                         f"{tuple(dy.shape)} strides {dy.stride()} for x {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if act == "identity":
        residual = None  # z is not needed
    sums = torch.empty((2, x.shape[-1]), dtype=torch.float64, device=x.device)
    work, stream = _sync_work(x, layout, residual, dy)
    status = getattr(build.library(), f"scenerf_bn_bwd_sums_{DTYPES[x.dtype]}")(
        x.data_ptr(), build.ptr(residual), dy.data_ptr(), x.numel() // x.shape[-1], x.shape[-1],
        layout, stats.data_ptr(), sums.data_ptr(), work.data_ptr(), work.numel(),
        ACTS.index(act), stream)
    build.check(status, "batch_norm_act synced backward sums")
    build.count_launch("bn_sync_bwd_sums", x.dtype)
    return sums


def launch_grads_finalize(local: torch.Tensor, world: torch.Tensor, M: int, x: torch.Tensor,
                          stats: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """The synced N3's finalize on the card (`grads_finalize_plain`)."""
    C = local.shape[1]
    grads = torch.empty((4, C), dtype=torch.float32, device=local.device)
    status = build.library().scenerf_bn_grads_finalize(
        local.data_ptr(), world.data_ptr(), M, C, weight.data_ptr(), stats.data_ptr(),
        grads.data_ptr(), eps, 1, build.stream_handle(local.device))
    build.check(status, "batch_norm_act synced gradients")
    build.count_launch("bn_sync_grads", x.dtype)
    return grads


class _SyncedBatchNormAct(torch.autograd.Function):
    """The synced path of a training site (the module docstring), on the card
    or in the plain stage functions (a CPU tensor). Saves x, the residual and
    the statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, running, momentum, eps, act, group):
        kernel = build.use_kernel(x, "bn")
        M = (x.numel() // x.shape[-1]) * D.size(group)
        sums = _all_reduce(launch_sums(x) if kernel else sums_plain(x), group)
        if kernel:
            stats = launch_stats_finalize(sums, M, x, weight, bias, *running, momentum, eps)
            y, _ = launch_forward(x, weight, bias, *running, True, momentum, eps, act, residual,
                                  stages=2, stats=stats)
        else:
            with torch.no_grad():
                stats = stats_finalize_plain(sums, M, weight, bias, *running, momentum, eps)
            y = apply_plain(x, stats, act, residual)
        ctx.save_for_backward(x, residual, weight, stats)
        ctx.args = (eps, act, group, M, kernel)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, residual, weight, stats = ctx.saved_tensors
        eps, act, group, M, kernel = ctx.args
        if kernel:
            if plane(dy) != plane(x):
                dy = torch.empty_like(x).copy_(dy)
            local = launch_bwd_sums(x, dy, stats, act, residual)
            world = _all_reduce(local.clone(), group)
            grads = launch_grads_finalize(local, world, M, x, stats, weight, eps)
            dx, _, d_res = launch_backward(x, dy, weight, stats, True, eps, act, residual,
                                           residual_grad=ctx.needs_input_grad[3], stages=2,
                                           grads=grads)
        else:
            local = bwd_sums_plain(x, dy, stats, act, residual)
            world = _all_reduce(local.clone(), group)
            grads = grads_finalize_plain(local, world, M, stats, weight, eps)
            dx, d_res = bwd_apply_plain(x, dy, stats, grads, act, residual)
            if not ctx.needs_input_grad[3]:
                d_res = None
        return dx, grads[DWEIGHT], grads[DBIAS], d_res, None, None, None, None, None


def batch_norm_act_synced(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                          running_mean: torch.Tensor, running_var: torch.Tensor,
                          momentum: float, eps: float, act: str = "identity",
                          residual: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    """The training op with its batch statistics reduced over `group` (a
    `torch.distributed` process group; None: a world of one rank, whose
    all-reduces are the identity): the split of the module docstring, on
    the card for a CUDA tensor and in the plain stage functions for a CPU
    one. Every rank must call it at the same sites in the same order, with
    the same number of rows."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    return _SyncedBatchNormAct.apply(x, weight, bias, residual, (running_mean, running_var),
                                     momentum, eps, act, group)


def batch_norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   running_mean: torch.Tensor, running_var: torch.Tensor, training: bool,
                   momentum: float, eps: float, act: str = "identity",
                   residual: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    """The fused op (see the module docstring): the kernels on a CUDA tensor,
    `batch_norm_act_plain` on a CPU tensor; in training mode with a `group`,
    the synced path (`batch_norm_act_synced`)."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if training and group is not None:
        return batch_norm_act_synced(x, weight, bias, running_mean, running_var, momentum, eps,
                                     act, residual, group)
    if not build.use_kernel(x, "bn"):
        return batch_norm_act_plain(x, weight, bias, running_mean, running_var, training,
                                    momentum, eps, act, residual)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad
                                    or (residual is not None and residual.requires_grad)):
        return _BatchNormAct.apply(x, weight, bias, residual, (running_mean, running_var),
                                   training, momentum, eps, act)
    return launch_forward(x, weight, bias, running_mean, running_var, training, momentum, eps,
                          act, residual, want_stats=False)[0]
