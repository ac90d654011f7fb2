"""The readings of the program against the plain reference on the same
inputs. A cell's `limits/<cell>.json` picks which of them decide
`correct`, each with the readings its limit was set from; the others are
printed beside them.

Training, the first three steps of the object the window then drives:
- `loss_gap.step<i>`: |loss - ref| / |ref| at step i, `loss_gap` the
  largest; `<metric>_gap.step1`: the same of each loss part and log of the
  first step;
- `grad_gap`: the first gradient's norm per leaf (the program's worked out
  from AdamW's first moment after one step, m / (1 - beta1)), the largest
  over the leaves of |norm - ref norm| / max(ref norm, median leaf's ref
  norm); `grad_gap.median_leaf`, `.p90_leaf`, `.top` (the worst four);
- `change_gap`, `change_gap.median_leaf`, ...: the same of the norm of
  each leaf's change over the three steps;
- `bn_stats_gap`: the batch statistics each batch norm site used in the
  first forward, recovered from its running statistics, against the
  reference's, at the median site.
Leaves whose reference gradient is under a thousandth of the median leaf's
move under Adam by round-off alone and are left out of the leaf gaps (the
rule reads the reference's gradient, never a name).

Training, the probe (one step after the window, checked stage by stage
from the program's state; `drivers/train.py`), against the reference in
the configuration's precision:
- `probe.loss_gap`: the largest |part - ref| / |ref| of the four losses;
- `probe.pyramid_grad_gap`, `probe.mlp_grad_gap`, `probe.enc_grad_gap`:
  |g - ref| / |ref| of the gradient of the encoder's output, of the fields'
  parameters and of the encoder's parameters, each as one vector;
- `probe.bn_gap`: the encoder's batch statistics at the median site;
- `probe.adamw_gap`: the largest over the leaves of |change - ref change| /
  max(|ref change|, the median leaf's).
For a bfloat16 configuration, besides, the same distances from the float32
reference, in units of the bfloat16 reference's own distance from it
(`probe.loss_ratio`, `probe.pyramid_grad_ratio`, ..., `probe.bn_ratio`:
the median over the sites of each site's ratio): how much further from the
function the program lies than rounding to the stated precision puts it.
Any bfloat16 computation reads about 1, whatever the order of its
roundings; one in a lower precision reads more.

Sweeps (poses rendered in the window, a sample drawn from the seed):
- `depth_err`: the mean over the sampled poses' pixels of |depth - ref| /
  ref, and its median, 90th and 99th percentiles and largest;
- `color_err`: the mean of |color - ref| over their pixels and channels,
  and its median;
- for a bfloat16 configuration, `depth_ratio.median`, `color_ratio.median`
  (and `.mean`): the median (mean) pixel's distance from the float32
  reference over the bfloat16 reference's.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

LEAF_FLOOR = 1e-3
LOSS_PARTS = ("loss_reprojection", "loss_color", "loss_som_kl", "loss_dist2closest_gauss")


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], ref_grad: Dict[str, float]
              ) -> Dict[str, float]:
    """{leaf: |prog - ref| / max(ref, median ref)} over the leaves that the
    reference's gradient moves."""
    med_g = statistics.median(ref_grad.values())
    keep = [k for k in ref if ref_grad[k] >= LEAF_FLOOR * med_g]
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep}


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog / ref: {"losses": [floats per step], "parts": [{metric: value}
    per step], "grad": {leaf: norm}, "change": {leaf: norm}, "bn": {buffer:
    batch statistics}}."""
    g = leaf_gaps(prog["grad"], ref["grad"], ref["grad"])
    c = leaf_gaps(prog["change"], ref["change"], ref["grad"])
    out = {f"loss_gap.step{i + 1}": rel(a, b)
           for i, (a, b) in enumerate(zip(prog["losses"], ref["losses"]))}
    out["loss_gap"] = max(out.values())
    out["grad_gap"] = max(g.values())
    out["change_gap"] = max(c.values())
    out["grad_gap.median_leaf"] = statistics.median(g.values())
    out["change_gap.median_leaf"] = statistics.median(c.values())
    out["leaves_kept"] = len(g)
    for name, gaps, side in (("grad", g, "grad"), ("change", c, "change")):
        med = statistics.median(ref[side][k] for k in gaps)
        out[f"{name}_gap.p90_leaf"] = sorted(gaps.values())[int(0.9 * (len(gaps) - 1))]
        out[f"{name}_gap.top"] = [
            [k, round(gaps[k], 5), prog[side][k], ref[side][k], med]
            for k in sorted(gaps, key=gaps.get, reverse=True)[:4]]
    out.update(bn_gaps(prog["bn"], ref["bn"]))
    for k in prog["parts"][0]:
        if k in ref["parts"][0]:
            out[f"{k}_gap.step1"] = rel(prog["parts"][0][k], ref["parts"][0][k])
    return out


def bn_site_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Per batch norm site of a training forward: the larger of the gap of
    the batch mean in units of the reference's batch std and of the batch
    variance relative to the reference's."""
    import torch

    out = {}
    for s in sorted({k.rsplit(".", 1)[0] for k in ref}):
        m_p, v_p = prog[s + ".running_mean"], prog[s + ".running_var"]
        m_r, v_r = ref[s + ".running_mean"], ref[s + ".running_var"]
        std = torch.sqrt(torch.clamp(v_r, min=1e-30))
        out[s] = max(float(torch.linalg.vector_norm(m_p - m_r) / torch.linalg.vector_norm(std)),
                     float(torch.linalg.vector_norm(v_p - v_r) / torch.linalg.vector_norm(v_r)))
    return out


def bn_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The median site of `bn_site_gaps` (and the 90th percentile: the worst
    sites hold a variance near 0, which the recovery from the running
    statistics cannot resolve)."""
    gaps = sorted(bn_site_gaps(prog, ref).values())
    return {"bn_stats_gap": statistics.median(gaps),
            "bn_stats_gap.p90_site": gaps[int(0.9 * (len(gaps) - 1))], "bn_sites": len(gaps)}


GRAD_GROUPS = {  # probe number -> (side key, which leaves)
    "pyramid_grad": ("level_grads", lambda n: True),
    "mlp_grad": ("grads", lambda n: not n.startswith("net_rgb.")),
    "enc_grad": ("grads", lambda n: n.startswith("net_rgb.")),
}


def _vector(side: Dict, keys, like: Dict):
    """The tensors of `side` under `keys`, as one float64 vector (zeros
    where `side` has none)."""
    import torch

    return torch.cat([(side[k] if k in side else torch.zeros_like(like[k])).double().flatten()
                      for k in keys])


def _distance(a: Dict, b: Dict, keys) -> float:
    import torch

    return float(torch.linalg.vector_norm(_vector(a, keys, b) - _vector(b, keys, a)))


def probe_numbers(prog: Dict, ref: Dict, f32: Optional[Dict] = None) -> Dict[str, float]:
    """prog / ref / f32: {"parts": {loss: value}, "level_grads": {level:
    tensor}, "grads": {leaf: tensor}, "bn": {buffer: batch statistics}} of
    the probe step (module docstring)."""
    import torch

    out = {"probe.loss_gap": max(rel(prog["parts"][k], ref["parts"][k]) for k in LOSS_PARTS)}
    for name, (key, pick) in GRAD_GROUPS.items():
        keys = [k for k in ref[key] if pick(k)]
        norm = float(torch.linalg.vector_norm(_vector(ref[key], keys, ref[key])))
        out[f"probe.{name}_gap"] = _distance(prog[key], ref[key], keys) / max(norm, 1e-30)
    out["probe.bn_gap"] = bn_gaps(prog["bn"], ref["bn"])["bn_stats_gap"]
    if f32 is None:
        return out

    def over(a, b):
        return a / max(b, 1e-30)

    out["probe.loss_ratio"] = over(
        math.hypot(*(rel(prog["parts"][k], f32["parts"][k]) for k in LOSS_PARTS)),
        math.hypot(*(rel(ref["parts"][k], f32["parts"][k]) for k in LOSS_PARTS)))
    for name, (key, pick) in GRAD_GROUPS.items():
        keys = [k for k in f32[key] if pick(k)]
        out[f"probe.{name}_ratio"] = over(_distance(prog[key], f32[key], keys),
                                          _distance(ref[key], f32[key], keys))
    p_sites, r_sites = bn_site_gaps(prog["bn"], f32["bn"]), bn_site_gaps(ref["bn"], f32["bn"])
    out["probe.bn_ratio"] = statistics.median(
        over(p_sites[s], r_sites[s]) for s in r_sites if r_sites[s] > 0)
    return out


def adamw_numbers(norms: Dict[str, tuple]) -> Dict[str, float]:
    """norms: {leaf: (|change - ref change|, |ref change|)} -> the largest
    over the leaves of the first over max(the second, the median leaf's)."""
    med = statistics.median(r for _, r in norms.values())
    gaps = {k: d / max(r, med, 1e-30) for k, (d, r) in norms.items()}
    worst = max(gaps, key=gaps.get)
    return {"probe.adamw_gap": gaps[worst], "probe.adamw_gap.leaf": worst}


def sweep_numbers(pairs: List[dict]) -> Dict[str, float]:
    """pairs: [{"depth", "ref_depth", "color", "ref_color"} as f32 host
    tensors] -> the compared numbers and diagnostics."""
    import torch

    d = torch.cat([(p["depth"] - p["ref_depth"]).abs().flatten()
                   / p["ref_depth"].abs().clamp(min=1e-6).flatten() for p in pairs])
    c = torch.cat([(p["color"] - p["ref_color"]).abs().flatten() for p in pairs])
    ds, cs = d[:1 << 24].double(), c[:1 << 24].double()
    out = {"depth_err": float(d.mean()), "color_err": float(c.mean()),
           "depth_err.median": float(torch.quantile(ds, 0.5)),
           "color_err.median": float(torch.quantile(cs, 0.5)),
           "depth_err.p90": float(torch.quantile(ds, 0.9)),
           "depth_err.p99": float(torch.quantile(ds, 0.99)),
           "depth_err.max": float(d.max())}
    if "f32_depth" in pairs[0]:
        out.update(sweep_ratios(pairs))
    return out


def sweep_ratios(pairs: List[dict]) -> Dict[str, float]:
    """The program's distance from the float32 reference ("f32_depth",
    "f32_color") over the reference's in the configuration's precision, at
    the median pixel and on the mean."""
    import torch

    out = {}
    for q in ("depth", "color"):
        def gap(key):
            g = torch.cat([(p[key] - p[f"f32_{q}"]).abs().flatten()
                           / (p[f"f32_{q}"].abs().clamp(min=1e-6).flatten() if q == "depth"
                              else 1.0) for p in pairs]).double()
            return float(torch.quantile(g[:1 << 24], 0.5)), float(g.mean())

        (pm, pa), (rm, ra) = gap(q), gap(f"ref_{q}")
        out[f"{q}_ratio.median"] = pm / max(rm, 1e-30)
        out[f"{q}_ratio.mean"] = pa / max(ra, 1e-30)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every compared number finite and within its limit."""
    return bool(limits) and all(
        k in numbers and math.isfinite(numbers[k]) and numbers[k] <= lim
        for k, lim in limits.items())
