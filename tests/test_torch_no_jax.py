"""The port runs where JAX is not installed: in a fresh interpreter where
`jax`, `flax` and the JAX package `scenerf_tpu` cannot be imported, every
module of `scenerf_tpu_torch` imports, and so do `chip_smoke.py` and the
port's scripts that drive it (SCRIPTS, whose functions name no JAX module
either). The library's modules (all but `cli/`) import no `click` either."""
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK = r'''
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "scenerf_tpu")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked: the port must not import it")
        return None


sys.meta_path.insert(0, Block())
sys.path.insert(0, REPO)
import scenerf_tpu_torch

names = sorted(m.name for m in pkgutil.walk_packages(scenerf_tpu_torch.__path__,
                                                     "scenerf_tpu_torch."))
'''


def run(code: str) -> str:
    res = subprocess.run([sys.executable, "-c", f"REPO = {REPO!r}\n" + BLOCK + code],
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stderr
    return res.stdout


SCRIPTS = ("import_reference_ckpt_torch", "quality_runs_torch", "overfit_probe_torch",
           "smoke_eval_chain_torch")


@pytest.mark.parametrize("part", ["library", "cli and chip_smoke", "scripts"])
def test_port_imports_without_jax(part):
    if part == "library":
        out = run('''
lib = [n for n in names if not n.startswith("scenerf_tpu_torch.cli")]
for n in ("scenerf_tpu_torch.data.bundlefusion", "scenerf_tpu_torch.fusion.meshing",
          "scenerf_tpu_torch.fusion.tsdf", "scenerf_tpu_torch.native.build",
          "scenerf_tpu_torch.parallel.dist", "scenerf_tpu_torch.parallel.sharded_render"):
    assert n in lib, n
for n in lib:
    importlib.import_module(n)
assert "click" not in sys.modules, "a library module imported click"
print(len(lib))
''')
        assert int(out) >= 30
    elif part == "scripts":
        out = run(f'''
import importlib.util
for name in {SCRIPTS!r}:
    spec = importlib.util.spec_from_file_location(name, f"{{REPO}}/scripts/{{name}}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert callable(module.main), name
print(len({SCRIPTS!r}))
''')
        assert int(out) == len(SCRIPTS)
        for name in SCRIPTS:
            with open(os.path.join(REPO, "scripts", name + ".py")) as f:
                assert not re.search(r"^\s*(import|from)\s+(jax|flax|scenerf_tpu)\b", f.read(),
                                     re.M), name
    else:
        out = run('''
for n in names:
    importlib.import_module(n)
for n in ("scenerf_tpu_torch.cli.train", "scenerf_tpu_torch.cli.evaluation",
          "scenerf_tpu_torch.cli.reconstruction"):
    assert n in names, n
import chip_smoke
assert callable(chip_smoke.main)
print(sum(n.startswith("scenerf_tpu_torch.cli") for n in names))
''')
        assert int(out) >= 5
