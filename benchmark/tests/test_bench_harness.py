"""The harness on the CPU: every cell, configuration, mix and metric found
by name; the spec within the benchmark contract's limits; the result line
built from the drivers at the `tiny` preset; faults planted under the timed
path turning `correct` false; the control made of the reference one
precision below; the trace readers on a synthetic trace; and a new cell
added as new files only. `run.py` itself refuses to run without a card."""
import json
import re
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import compare, lowp
from benchmark.harness.cell import BENCH, ROOT, Cell, applies, load_module, load_spec
from benchmark.harness.trace import Brackets, Trace, union_us

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
RUN = load_module(BENCH / "run.py", "benchmark_run_module")

TINY = {"cam_K": [[40.0, 0, 32.0], [0, 40.0, 24.0], [0, 0, 1]],
        "scene": {"depth": [3.0, 8.0], "texture_per_m": 1.0, "source_step": 0.3},
        "sweep": {"step": 0.5, "angles": [0.0, 10.0, -10.0], "max_distance": 1.1}}


def tiny_cell(name: str, **overrides) -> Cell:
    """The cell `name` with its configuration at the `tiny` preset (and
    `overrides`) and its dtype kept: everything else (traffic, limits,
    metrics) as committed."""
    cell = Cell(SPEC, name)
    dt = cell.conf["dtype"]
    cell.conf = {"preset": "tiny",
                 "overrides": {"compute_dtype": dt, "img_size": [64, 48], **overrides},
                 "dtype": dt, **TINY}
    return cell


# ------------------------------------------------------------ the spec


def test_spec_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert len(json.dumps(SPEC)) < 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m["workloads"]) <= set(next(x for x in SPEC["end_to_end"]
                                               if x["name"] == m["moves"]).get("workloads",
                                                                                CELLS))
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        per_cell = [m["name"] for m in SPEC["end_to_end"] if applies(m, w["name"])]
        assert "setup_s" in per_cell and len(per_cell) >= 2
        assert any(applies(m, w["name"]) for m in SPEC["per_layer"])


def test_run_seconds_fit_a_full_check():
    # 2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s a cell, 1200 s spare
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    cell = Cell(SPEC, name)
    drv = cell.driver()
    assert drv.KIND == cell.traffic["driver"]
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    for m in cell.per_layer:
        assert callable(cell.metric_reader(m["name"]).read)
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/configs/") and (ROOT / c["file"]).exists()


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        Cell(SPEC, "no-such-cell")


# ------------------------------------------------------------ result line


def run_tiny(name: str, fault=None) -> dict:
    # a sweep's window has to hold an encode and a pose on a busy CPU
    cell = tiny_cell(name)
    seconds = 5.0 if cell.traffic["driver"] == "sweep" else 0.5
    return RUN.run_cell(cell, 2 ** 33 + 17, seconds, False, "cpu", time.perf_counter(),
                        fault=fault)


@pytest.mark.parametrize("name", CELLS)
def test_result_line_shape(name):
    line = run_tiny(name)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    cell = Cell(SPEC, name)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["checks"]) == set(cell.limits)
    assert all(c["value"] is not None for c in line["checks"].values())
    assert line["device"]["platform"] == "cpu"  # never a device's name from the CPU
    json.dumps(line)


@pytest.mark.parametrize("name", ["bf-train-f32", "bf-sweep-f32"])
def test_sound_f32_run_is_correct(name):
    # in f32 on the CPU the program runs its plain versions: equal to the
    # reference's copies
    assert run_tiny(name)["correct"] is True


@pytest.mark.parametrize("name,fault", [
    ("kitti-train-bf16", "unchanged"), ("kitti-train-bf16", "half_batch"),
    ("bf-train-f32", "unchanged"), ("bf-train-f32", "half_batch"),
    ("kitti-sweep-bf16", "altered"), ("bf-sweep-f32", "altered")])
def test_fault_under_the_timed_path_is_not_correct(name, fault):
    """Each fault the cell can have turns `correct` false, with the cell's
    limits, at the tiny preset."""
    assert run_tiny(name, fault)["correct"] is False


def test_the_probe_follows_the_program():
    """The probe's stages against the reference in the program's own
    precision: on the CPU the program runs its kernels' plain versions, so
    the render, the losses and the encoder agree to rounding, and AdamW's
    step is the reference's to the parameters' float32."""
    cell = tiny_cell("kitti-train-bf16")
    drv = cell.driver().Driver(cell, 2 ** 33 + 17, "cpu")
    drv.setup()
    drv.window(0.3, Brackets())
    drv.release()
    sides = drv.probe_sides()
    nums = compare.probe_numbers(drv.program_probe(), sides["ref"], sides["f32"])
    nums.update(compare.adamw_numbers(drv.adamw_norms()))
    assert nums["probe.loss_gap"] == 0 and nums["probe.mlp_grad_gap"] == 0
    assert nums["probe.pyramid_grad_gap"] < 1e-2  # the gradient's bf16 rounding
    assert nums["probe.enc_grad_gap"] == 0 and nums["probe.bn_gap"] == 0
    assert all(abs(nums[f"probe.{k}_ratio"] - 1) < 1e-2
               for k in ("loss", "mlp_grad", "pyramid_grad", "enc_grad", "bn"))
    assert nums["probe.adamw_gap"] < 1e-3
    assert drv.probe["index"] >= int(cell.traffic["warmup_steps"])  # after the window


@pytest.mark.parametrize("name", ["kitti-train-bf16", "kitti-sweep-bf16"])
def test_fp8_control_is_not_correct(name):
    """The bf16 cells' control, the reference with fp8 products in the
    program's place, fails the cell's limits (the f32 cells' TF32 control
    needs a card: test_bench_reference.py). The training cell's control
    runs a real EfficientNet (B0, 49 sites) at the tiny image size: the
    tiny encoder's 30 shallow sites move too little under fp8."""
    cell = (tiny_cell(name, encoder="effnet-b0", encoder_features=1280)
            if name.startswith("kitti-train") else tiny_cell(name))
    drv = cell.driver().Driver(cell, 2 ** 33 + 17, "cpu")
    drv.setup()
    drv.window(0.5 if drv.kind == "train" else 5.0, Brackets())
    if drv.kind == "train":
        drv.release()
        sides = drv.probe_sides("bfloat16")
        nums = compare.train_numbers(drv.reference(lower="bfloat16"), drv.reference())
        nums.update(compare.probe_numbers(sides["control"], sides["ref"], sides["f32"]))
        nums.update(compare.adamw_numbers(drv.adamw_norms()))
    else:
        nums = compare.sweep_numbers(drv.pairs(drv.sample(), "bfloat16"))
    assert not compare.verdict(nums, cell.limits), nums


def test_fp8_rounding():
    x = torch.tensor([1.0, 0.3, -448.0, 1e-3])
    y = lowp.fp8_round(x)
    assert y[2] == -448.0 and y[0] == 1.0 and y[1] != 0.3
    assert lowp.fp8_round(torch.tensor([2, 3])).dtype == torch.int64


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 3 and out.stdout == ""


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


# ------------------------------------------------------------ trace


def synthetic_trace():
    """Markers at 100 and 1000 us; kernels 200-300, 250-400 (overlapping),
    a copy 500-550, gather 600-650, bn 700-800; host brackets in ns with
    the offset ts = host_ns / 1e3 - 0."""
    ev = lambda name, cat, ts, dur: {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    events = [ev("fill marker", "kernel", 100, 5),
              ev("void gemm_kernel<>", "kernel", 200, 100),
              ev("void elementwise", "kernel", 250, 150),
              ev("Memcpy HtoD", "gpu_memcpy", 500, 50),
              ev("void gather_levels_kernel<float>", "kernel", 600, 50),
              ev("void gather_levels_bwd_kernel<float>", "kernel", 650, 20),
              ev("void bn_forward_cluster_kernel<>", "kernel", 700, 100),
              ev("fill marker", "kernel", 1000, 5),
              {"ph": "i", "name": "ignored"}]
    brackets = [("train_step", 100_000, 450_000), ("to_host", 450_000, 1_000_000)]
    return Trace(events, 100_000, 1_000_000, brackets)


def test_trace_union_gaps_and_kinds():
    tr = synthetic_trace()
    assert tr.window_us == 1000 - 105
    busy, merged = tr.busy()
    assert merged == [(200, 400), (500, 550), (600, 670), (700, 800)] and busy == 420
    gaps = tr.idle_gaps()
    assert gaps[0] == ("to_host", 200 / 1e6) and ("train_step", 95 / 1e6) in gaps
    assert sum(g for _, g in gaps) == pytest.approx((895 - 420) / 1e6)
    assert len(tr.kernels()) == 5 and sum(d for _, d in tr.kernels("gather_levels_kernel")) == 50
    kinds = tr.by_kind()
    assert kinds["GEMM (cuBLAS)"] == pytest.approx(100e-6)
    assert kinds["gpu_memcpy"] == pytest.approx(50e-6)
    assert tr.top_ops(2)[0][0].startswith("elementwise and other: ")
    assert union_us([(0, 1), (1, 2), (5, 6)]) == (3, [(0, 2), (5, 6)])


def test_metric_readers_on_a_synthetic_trace():
    tr = synthetic_trace()
    brackets = Brackets()
    brackets.spans = [("train_step", 0, 2_000_000), ("train_step", 0, 4_000_000)]
    rec = SimpleNamespace(kind="train", trace=tr, profiled_units=2, profiled_encodes=0,
                          brackets=brackets, window={"units": 10, "seconds": 2.0},
                          work={"flops": 1e12, "peak_flops": 1e13, "G_s": 10e-6,
                                "K5_s": 20e-6})
    read = lambda m: Cell(SPEC, "kitti-train-bf16").metric_reader(m).read(rec)
    assert read("idle_pct.train") == pytest.approx(100 * (1 - 420 / 895))
    assert read("kernels_per_step.train") == 2.5
    assert read("G_roofline.train") == pytest.approx(100 * 2 * 10e-6 / 50e-6)
    assert read("K5_roofline.train") == pytest.approx(100 * 2 * 20e-6 / 100e-6)
    assert read("mfu.train") == pytest.approx(100 * 1e12 * 10 / 2.0 / 1e13)
    assert read("launch_ms.train") == 3.0
    assert read("idle_pct.render") is None  # nothing of a sweep to read


# ------------------------------------------------------------ extending


def test_a_new_cell_is_new_files_only(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files plus BENCHMARK.json entries, no file of the harness edited."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    conf = {"preset": "tiny", "overrides": {"img_size": [64, 48], "n_sources": 1},
            "dtype": "float32", "source": "tiny", "reduced": [], **TINY}
    (bench / "configs" / "tiny.json").write_text(json.dumps(conf))
    (bench / "traffic" / "train-two.json").write_text(json.dumps(
        {"driver": "train", "batches": 2, "warmup_steps": 3, "profile_steps": 1}))
    (bench / "limits" / "tiny-train.json").write_text(json.dumps(
        {k: {"limit": 1e-3} for k in ("loss_gap.step1", "bn_stats_gap")}))
    (bench / "metrics" / "steps.train.py").write_text(
        "def read(rec):\n    return float(rec.window['units'])\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "tiny", "source": "tiny", "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny-train", "config": "tiny", "traffic": "train-two",
                              "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "bf-train-f32" in m["workloads"]:
            m["workloads"].append("tiny-train")
    spec["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "device",
                              "moves": "train_rays_per_s", "workloads": ["tiny-train"]})
    cell = Cell(spec, "tiny-train", bench=bench)
    assert cell.limits and [m["name"] for m in cell.per_layer] == ["steps.train"]
    line = RUN.run_cell(cell, 5, 0.3, False, "cpu", time.perf_counter())
    assert line["correct"] is True and "train_rays_per_s" in line["metrics"]
    rec = SimpleNamespace(window={"units": 4})
    assert RUN.per_layer(cell, rec) == {"steps.train": {"value": 4.0, "unit": "steps"}}
    assert all(p.read_bytes() == b for p, b in before.items())
