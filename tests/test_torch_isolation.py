"""The port stands alone: ``repro_torch`` (its apps, its trainer, its
mesh paths and its step analysis included), ``chip_smoke.py`` and the
port's examples (``examples/*_torch.py``) import
neither JAX nor the JAX package, the package no
``torch.testing._internal``, and its entry points refuse to fall back to
the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))

_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch, repro_torch.apps, repro_torch.core, repro_torch.kernels, repro_torch.obs
import repro_torch.configs, repro_torch.models, repro_torch.launch.serve
import repro_torch.models.offload, repro_torch.models.weights, repro_torch.models.moe
import repro_torch.models.ssm, repro_torch.models.graph
import repro_torch.train, repro_torch.train.checkpoint, repro_torch.train.data
import repro_torch.launch.train
import repro_torch.distributed.sharding, repro_torch.distributed.spmd
import repro_torch.distributed.compression
import repro_torch.launch.mesh, repro_torch.launch.specs, repro_torch.launch.dryrun
import repro_torch.analysis, repro_torch.analysis.op_analysis, repro_torch.core.cachesim
import chip_smoke
from repro_torch.core import Session
s = Session("ooc", device="cpu", num_tiles=2, capacity_bytes=float("inf"))
import torch
cfg = repro_torch.configs.get_reduced_config("llama3_2_1b")
m = repro_torch.models.init_params(cfg, generator=torch.Generator(), device="cpu")
assert repro_torch.launch.serve.main(["--arch", "llama3_2_1b", "--reduced",
                                      "--device", "cpu", "--offload", "--quiet"]) == 0
assert repro_torch.launch.serve.main(["--arch", "mamba2_1_3b", "--reduced",
                                      "--device", "cpu", "--quiet"]) == 0
assert repro_torch.launch.train.main(["--arch", "llama3_2_1b", "--reduced",
                                      "--device", "cpu", "--steps", "2", "--quiet"]) == 0
a = repro_torch.analysis.analyze_step(
    lambda: repro_torch.models.forward(m, torch.zeros((1, 4), dtype=torch.long)), 1)
assert a["dot_flops"] > 0 and a["hbm_bytes"] > 0
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
print("isolated")
"""


def test_imports_with_jax_and_repro_blocked():
    code = _BLOCKED.format(src=str(ROOT / "src"), root=str(ROOT))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("isolated")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [SMOKE],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_torch_testing_internals_in_the_package(path):
    """The package never imports ``torch.testing._internal`` (its fake and
    threaded process groups are for tests and ``chip_smoke.py``)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in names if m.startswith("torch.testing._internal")]


def test_default_device_never_falls_back_to_cpu():
    from repro_torch.core import Session
    from repro_torch.serve import StencilServer

    if torch.cuda.is_available():
        assert Session("ooc").backend.device.type == "cuda"
        with StencilServer("sim:1") as srv:
            assert srv.lanes[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Session("ooc")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Session("cuda")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            StencilServer("sim:1")


def test_model_decode_never_falls_back_to_cpu():
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import init_cache, init_params

    for arch in ("llama3_2_1b", "deepseek_v2_lite_16b"):     # dense, moe with MLA
        cfg = get_reduced_config(arch)
        if torch.cuda.is_available():
            model = init_params(cfg, generator=torch.Generator(device="cuda"))
            assert model.embed.device.type == "cuda"
            assert init_cache(cfg, 1, 4)["k" if arch == "llama3_2_1b" else "ckv"].is_cuda
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                init_params(cfg, generator=torch.Generator())
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                init_cache(cfg, 1, 4)
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                launch_serve.main(["--arch", arch, "--reduced", "--quiet"])


def test_training_never_falls_back_to_cpu():
    from repro_torch.launch import train as launch_train

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the launcher would train on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--arch", "llama3_2_1b", "--reduced", "--steps", "1", "--quiet"])


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: chip_smoke.py would run")
    out = subprocess.run([sys.executable, str(SMOKE)], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


_EXAMPLE_BLOCKED = """
import importlib.util
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, {src!r})
spec = importlib.util.spec_from_file_location("example", {path!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
assert callable(mod.main)
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
print("isolated")
"""


def test_every_example_has_a_port():
    jax_examples = {p.stem for p in (ROOT / "examples").glob("*.py")} - {p.stem for p in EXAMPLES}
    assert {p.stem.removesuffix("_torch") for p in EXAMPLES} == jax_examples
    assert jax_examples == {"cloverleaf_outofcore", "quickstart", "serve_lm", "train_lm"}


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: str(p.relative_to(ROOT)))
def test_example_imports_with_jax_and_repro_blocked(path):
    """An example names neither package in any import statement, and loads
    with both blocked."""
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots
    code = _EXAMPLE_BLOCKED.format(src=str(ROOT / "src"), path=str(path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("isolated")
