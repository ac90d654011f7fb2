"""The general generator of training traffic: one trainer in a closed loop.

Set-up builds one `Trainer` of the program on weights drawn from the seed,
makes the traffic's batches (host numpy, the program's batch contract) and
every draw of each step (on the device), and drives the trainer through its
first steps, which warm up every shape of the window. The reference follows
those first steps from the same weights, batches and draws. The window then
drives the same trainer: step k takes batch k mod `batches` and its draws,
through `Trainer.train_step` and its upload from the host; it waits for the
device only at its end.

Once the window has closed (and after the traced steps of a traced run),
the same trainer takes one more step through the same call, the probe,
with what it computed on the way recorded: the encoder's output and its
gradient, the parameters' gradients as the optimizer gets them, the AdamW
moments before and the parameters before and after. The reference checks
that step stage by stage from the program's own state: the encoder's
forward and backward from the same parameters and statistics (fed the
program's gradient of its output), the render, losses and their backward
from the program's encoder output, and AdamW from the program's gradients
and moments. The render stage is where the step is chaotic (its sphere-cell
rounding, RaySOM's prototypes and mask, the reprojection minimum flip under
the encoder's rounding), so it starts from the same encoder output.

Traffic keys: `batches`, `warmup_steps` (the steps the reference follows),
`profile_steps` (steps traced after the window in a traced run),
`host_threads` (optional: the host's intra-op threads for the whole run;
the step's host copies into pinned memory are parallel regions, and on a
host whose cores are shared a parallel region waits for its slowest
thread).
"""
from __future__ import annotations

import statistics
import sys
import time
from functools import partial
from typing import Dict, List, Optional

import torch

from benchmark.harness import compare, inputs, lowp
from benchmark.harness.trace import Brackets, profiled

KIND = "train"
STEPS_PER_EPOCH = 1000  # the lr schedule's staircase, the same on both sides


def program_config(conf: dict):
    from scenerf_tpu_torch import config as C

    return C.PRESETS[conf["preset"]](**conf["overrides"])


def in_f32(conf: dict) -> dict:
    """The configuration computing in float32."""
    return {**conf, "overrides": {**conf["overrides"], "compute_dtype": "float32"}}


def reference_config(conf: dict):
    """The reference's config: the program's, in the precision the
    configuration states (bf16 compute keeps f32 parameters, AdamW state
    and batch-norm statistics, as the program's mixed precision)."""
    from benchmark.reference import config as RC

    return RC.PRESETS[conf["preset"]](**conf["overrides"])


def reference_model(conf: dict, device):
    """The reference model on `device` with no values yet."""
    from benchmark.reference.model import SceneRF as RefModel

    with torch.device("meta"):
        model = RefModel(reference_config(conf))
    return model.to_empty(device=device) if str(device) != "meta" else model


def precision(lower: Optional[str]):
    """The reference's arithmetic: TF32 off, or the control's (`lower`)."""
    return lowp.lowered(lower) if lower else lowp.exact_f32()


def weight_shapes(conf: dict) -> Dict[str, torch.Size]:
    """The state dict's names and shapes, read from the reference model."""
    return {k: v.shape for k, v in reference_model(conf, "meta").state_dict().items()}


def program_model(conf: dict, seed: int, device):
    """The program's SceneRF with the weights drawn from the seed."""
    from scenerf_tpu_torch.model import SceneRF

    with torch.device("meta"):
        model = SceneRF(program_config(conf))
    model = model.to_empty(device=device)
    model.load_state_dict(inputs.draw_weights(weight_shapes(conf), seed, device), strict=True)
    return model


def to_tensors(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, dtype=torch.float32).to(device) for k, v in batch.items()}


def running_stats(model) -> Dict[str, torch.Tensor]:
    """Every batch norm's running mean and variance, as host f64 copies."""
    return {k: v.detach().double().cpu() for k, v in model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


def batch_stats(model, before: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The batch statistics a training forward used at each site, recovered
    from its running statistics before and after it (running <- momentum *
    running + (1 - momentum) * batch, with each site's own momentum)."""
    after = running_stats(model)
    momentum = {name: float(m.momentum) for name, m in model.named_modules()
                if hasattr(m, "running_mean")}
    return {k: (after[k] - momentum[k.rsplit(".", 1)[0]] * before[k])
            / (1.0 - momentum[k.rsplit(".", 1)[0]]) for k in after}


def add_into(total: torch.Tensor, g: torch.Tensor) -> None:
    """A gradient hook that adds the gradient into `total` (and returns
    nothing, so the gradient goes on as it was)."""
    total.add_(g.float())


def norms(named) -> Dict[str, float]:
    out = {}
    for k, v in named:
        out[k] = float(torch.linalg.vector_norm(v.detach().double()))
    return out


def log_step_times(times: List[float], wall: float) -> None:
    """The window's host times a call on standard error: quantiles, and the
    time lost to calls over 1.5 times the median (stalls)."""
    if len(times) < 4:
        return
    q = statistics.quantiles(times, n=10)
    med = statistics.median(times)
    slow = [t for t in times if t > 1.5 * med]
    print(f"train_step host ms: min {min(times):.1f} p10 {q[0]:.1f} p50 {med:.1f} "
          f"p90 {q[8]:.1f} max {max(times):.1f}; {len(slow)} calls over 1.5x the median "
          f"lose {sum(t - med for t in slow) / 1e3:.3f} s of the {wall:.3f} s window",
          file=sys.stderr, flush=True)


class Driver:
    kind = KIND

    def __init__(self, cell, seed: int, device, fault: Optional[str] = None):
        """`fault` (tests and the readings of the limits only):
        "half_batch" renders half of each source's rays, the loss the mean
        over them; "unchanged" makes every step leave the parameters as they
        were; "witness_f32" is no fault but the program computing in
        float32, a second witness beside the reference."""
        self.cell, self.conf, self.traffic = cell, cell.conf, cell.traffic
        self.seed, self.device, self.fault = seed, torch.device(device), fault
        self.program_conf = in_f32(self.conf) if fault == "witness_f32" else self.conf
        self.cfg = program_config(self.program_conf)
        self.exact = self.cfg.compute_dtype == "float32"  # TF32 off for the program
        self.f32_side = self.conf["dtype"] != "float32"  # a float32 reference beside

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from scenerf_tpu_torch.train import Trainer

        if "host_threads" in self.traffic:
            torch.set_num_threads(int(self.traffic["host_threads"]))
        if self.exact:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        dev, cfg, n = self.device, self.cfg, int(self.traffic["batches"])
        self.batches = [inputs.make_batch(self.conf, cfg, self.seed, i) for i in range(n)]
        self.noises = [inputs.draw_noise(cfg, self.seed, i, dev) for i in range(n)]
        model = program_model(self.program_conf, self.seed, dev)
        start = {k: p.detach().clone() for k, p in model.named_parameters()}
        stats0 = running_stats(model)
        self.trainer = Trainer(cfg, device=dev, model=model, seed=0,
                               steps_per_epoch=STEPS_PER_EPOCH)
        if self.fault == "unchanged":
            self.trainer.optimizer.step = lambda *a, **k: None
        self.first = {"losses": [], "parts": []}
        for i in range(int(self.traffic["warmup_steps"])):
            m = self.step(i)
            self.first["losses"].append(float(m["total_loss"]))
            self.first["parts"].append({k: float(v) for k, v in m.items()})
            if i == 0:
                beta1 = self.trainer.optimizer.param_groups[0]["betas"][0]
                state = self.trainer.optimizer.state
                self.first["grad"] = norms(
                    (k, state[p]["exp_avg"] / (1 - beta1) if p in state and "exp_avg" in state[p]
                     else torch.zeros_like(p)) for k, p in model.named_parameters())
                self.first["bn"] = batch_stats(model, stats0)
        self.first["change"] = norms((k, p - start[k]) for k, p in model.named_parameters())
        del start
        self.steps_done = int(self.traffic["warmup_steps"])
        self.rays_per_step = cfg.n_sources * cfg.n_rays

    def step(self, k: int) -> Dict[str, torch.Tensor]:
        b = k % len(self.batches)
        noise = self.noises[b]
        if self.fault == "half_batch":
            half = self.cfg.n_rays // 2
            noise = {key: (v[:, :, :half] if key in ("pixels", "uni", "gauss", "reproj") else v)
                     for key, v in noise.items()}
        return self.trainer.train_step(self.batches[b], noise=noise)

    # ------------------------------------------------------------ window
    def window(self, seconds: float, brackets: Brackets) -> dict:
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        losses: List[torch.Tensor] = []
        failed = 0
        sync()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            try:
                with brackets("train_step"):
                    m = self.step(self.steps_done)
                losses.append(m["total_loss"])
            except Exception as e:  # a step that raises has failed
                failed += 1
                print(f"step {self.steps_done} raised: {e!r}", flush=True)
            self.steps_done += 1
        sync()
        wall = time.perf_counter() - t0
        finite = torch.isfinite(torch.stack(losses)).tolist() if losses else []
        failed += sum(1 for ok in finite if not ok)
        steps = len(finite) + failed
        self.window_steps, self.window_s = steps, wall
        log_step_times(brackets.durations_ms("train_step"), wall)
        return {"attempted": steps, "failed": failed, "seconds": wall, "units": steps,
                "metrics": {"train_rays_per_s": steps * self.rays_per_step / wall}}

    def profile(self, out_dir, holder: dict) -> None:
        brackets = Brackets()
        with profiled(out_dir / "trace.json", brackets, holder):
            for _ in range(int(self.traffic["profile_steps"])):
                with brackets("train_step"):
                    self.step(self.steps_done)
                self.steps_done += 1
        holder["units"] = int(self.traffic["profile_steps"])

    def release(self) -> None:
        """Take the probe step, then free the program."""
        self.probe = self.take_probe()
        del self.trainer
        self.noises = [{k: v.cpu() for k, v in n.items()} for n in self.noises]
        self._free()

    def take_probe(self) -> dict:
        """One more step of the trainer through `train_step`, with what the
        reference needs to check it stage by stage recorded (copies; the
        program's own values are left as they are)."""
        tr = self.trainer
        model, opt = tr.model, tr.optimizer
        params = dict(model.named_parameters())
        k = self.steps_done
        # the step count is the harness's: every call of train_step so far
        rec = {"index": k, "t": k + 1, "lr_step": k,
               "state": {n: v.detach().clone() for n, v in model.state_dict().items()},
               "adam": {n: (opt.state[p]["exp_avg"].clone(), opt.state[p]["exp_avg_sq"].clone())
                        for n, p in params.items() if "exp_avg" in opt.state.get(p, {})},
               "levels": {}, "level_grads": {}, "grads": {}}
        stats0 = running_stats(model)

        def encode(*a, **kw):
            levels = type(model).encode(model, *a, **kw)
            rec["levels"].update({key: t.detach().clone() for key, t in levels.items()})
            return levels

        def pyramid_for_item(levels, b):
            # the gradient the render gives each level of item b (a hook on
            # the level itself would also take what reaches it through the
            # finer levels that the decoder makes of it)
            views = type(model).pyramid_for_item(levels, b)
            for v in views:
                key = next(k for k, t in levels.items()
                           if t[b].shape == v.shape and t[b].data_ptr() == v.data_ptr())
                total = rec["level_grads"].setdefault(
                    key, torch.zeros(levels[key].shape, dtype=torch.float32, device=v.device))
                if v.requires_grad:
                    v.register_hook(partial(add_into, total[b]))
            return views

        optimizer_step = opt.step

        def step(*a, **kw):
            rec["grads"].update({n: p.grad.detach().clone() for n, p in params.items()
                                 if p.grad is not None})
            return optimizer_step(*a, **kw)

        model.encode, model.pyramid_for_item, opt.step = encode, pyramid_for_item, step
        try:
            m = self.step(k)
        finally:
            del model.encode, model.pyramid_for_item
            opt.step = optimizer_step
        self.steps_done += 1
        rec["metrics"] = {key: float(v) for key, v in m.items()}
        rec["after"] = {n: p.detach().clone() for n, p in params.items()}
        rec["bn"] = batch_stats(model, stats0)
        return rec

    # ------------------------------------------------------------ check
    def reference(self, lower: Optional[str] = None) -> dict:
        """The reference's first steps on the same weights, batches and
        draws, in the configuration's precision with TF32 off, or in the
        control's precision (`lower`: the configuration's dtype)."""
        dev, cfg = self.device, reference_config(self.conf)
        model = reference_model(self.conf, dev)
        model.load_state_dict(inputs.draw_weights(weight_shapes(self.conf), self.seed, dev))
        start = {k: p.detach().clone() for k, p in model.named_parameters()}
        stats0 = running_stats(model)
        opt = torch.optim.AdamW(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=cfg.weight_decay)
        out = {"losses": [], "parts": []}
        with precision(lower):
            maps = None
            for i in range(int(self.traffic["warmup_steps"])):
                b = i % len(self.batches)
                batch = to_tensors(self.batches[b], dev)
                if maps is None:
                    maps = {s: torch.as_tensor(m, device=dev) for s, m in
                            model.compute_sphere_maps(batch["cam_K"][0]).items()}
                noise = {k: v.to(dev) for k, v in self.noises[b].items()}
                opt.zero_grad(set_to_none=True)
                loss, metrics = model(batch, noise, train=True, sphere_maps=maps)
                loss.backward()
                if i == 0:
                    out["grad"] = norms((k, p.grad if p.grad is not None else torch.zeros_like(p))
                                        for k, p in model.named_parameters())
                    out["bn"] = batch_stats(model, stats0)
                opt.step()
                out["losses"].append(float(loss.detach()))
                out["parts"].append({k: float(v.detach()) for k, v in metrics.items()})
                del loss, metrics, batch, noise
        out["change"] = norms((k, p - start[k]) for k, p in model.named_parameters())
        del model, opt, start
        self._free()
        return out

    def probe_reference(self, conf: Optional[dict] = None, lower: Optional[str] = None
                        ) -> dict:
        """The probe step stage by stage, from the program's state before it,
        in `conf`'s precision (the cell's by default) with TF32 off, or the
        control's (`lower`): the encoder's batch statistics and, fed the
        program's gradient of its output, its parameters' gradients; the
        losses from the program's encoder output, their gradients of that
        output and of the fields' parameters."""
        conf = conf or self.conf
        dev, rec = self.device, self.probe
        model = reference_model(conf, dev)
        model.load_state_dict(rec["state"])
        b = rec["index"] % len(self.batches)
        batch = to_tensors(self.batches[b], dev)
        noise = {k: v.to(dev) for k, v in self.noises[b].items()}
        maps = {s: torch.as_tensor(m, device=dev)
                for s, m in model.compute_sphere_maps(batch["cam_K"][0]).items()}
        out = {}
        with precision(lower):
            model.train()
            stats0 = running_stats(model)
            levels = model.encode(batch["img_input"], batch["cam_K"][0], sphere_maps=maps)
            out["bn"] = batch_stats(model, stats0)
            keys = [k for k in levels if k in rec["level_grads"]]
            torch.autograd.backward([levels[k] for k in keys],
                                    [rec["level_grads"][k].to(levels[k].dtype) for k in keys])
            out["grads"] = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                            if p.grad is not None}
            del levels
            model.zero_grad(set_to_none=True)
            given = {k: v.to(model.cfg.dtype, copy=True).requires_grad_(True)
                     for k, v in rec["levels"].items()}
            loss, metrics = model(batch, noise, train=True, sphere_maps=maps,
                                  with_depth_eval=False, levels=given)
            loss.backward()
            out["parts"] = {k: float(metrics[k].detach()) for k in compare.LOSS_PARTS}
            out["level_grads"] = {k: v.grad.float() for k, v in given.items()}
            out["grads"].update({n: p.grad.detach().clone() for n, p in model.named_parameters()
                                 if p.grad is not None and not n.startswith("net_rgb.")})
        del model, given, loss, metrics
        self._free()
        return out

    def program_probe(self) -> dict:
        """The program's side of the probe, in `probe_reference`'s form."""
        rec = self.probe
        return {"bn": rec["bn"], "grads": rec["grads"], "level_grads": rec["level_grads"],
                "parts": {k: rec["metrics"].get(k, float("nan")) for k in compare.LOSS_PARTS}}

    def adamw_norms(self) -> Dict[str, tuple]:
        """{leaf: (|program's parameter - reference's|, |reference's
        change|)} after the probe's AdamW step: the reference's the update
        AdamW makes from the program's gradient and moments, at the step
        count and lr the harness counted (a leaf with no gradient does not
        move), rounded to the parameter's dtype."""
        from benchmark.reference.optim import adamw_step

        rec, cfg = self.probe, reference_config(self.conf)
        lr = cfg.lr * cfg.lr_decay_gamma ** (rec["lr_step"] // STEPS_PER_EPOCH)
        out = {}
        for n, before in rec["state"].items():
            if n not in rec["after"]:
                continue  # a buffer
            b = before.double()
            if n in rec["grads"]:
                m, v = rec["adam"].get(n, (None, None))
                ref = adamw_step(before, rec["grads"][n], m, v, rec["t"], lr,
                                 weight_decay=cfg.weight_decay)
            else:
                ref = b
            stored = ref.to(before.dtype).double()  # as the parameter holds it
            out[n] = (float(torch.linalg.vector_norm(rec["after"][n].double() - stored)),
                      float(torch.linalg.vector_norm(ref - b)))
        return out

    def probe_sides(self, lower: Optional[str] = None) -> dict:
        """The probe's sides: "ref" (the cell's precision), "f32" (a bf16
        cell's reference in float32), "control" (with `lower`)."""
        sides = {"ref": self.probe_reference()}
        if self.f32_side:
            sides["f32"] = self.probe_reference(in_f32(self.conf))
        if lower:
            sides["control"] = self.probe_reference(lower=lower)
        return sides

    def check(self) -> Dict[str, float]:
        nums = compare.train_numbers(self.first, self.reference())
        sides = self.probe_sides()
        nums.update(compare.probe_numbers(self.program_probe(), sides["ref"], sides.get("f32")))
        nums.update(compare.adamw_numbers(self.adamw_norms()))
        return nums

    def _free(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ counts
    def work(self) -> dict:
        """The work of one step, counted from the cell's shapes."""
        from benchmark.counts import gather, model_flops, norm, peaks

        cfg = reference_config(self.conf)
        itemsize = 2 if self.conf["dtype"] == "bfloat16" else 4
        enc = model_flops.encoder(self.conf)
        return {"flops": model_flops.train_step(self.conf, cfg),
                "peak_flops": peaks.flops(self.conf["dtype"]),
                "G_s": gather.train_step_s(cfg, model_flops.d_latent(self.conf),
                                           enc["sphere_gathers"], itemsize),
                "K5_s": norm.train_step_s(enc["bn_sites"], itemsize)}
