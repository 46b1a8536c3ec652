"""The port stands alone: nothing under ``src/repro_torch`` (nor
``chip_smoke.py``) imports JAX, the JAX package or Triton (every kernel is
CUDA C++ built by ``nvcc``), importing it builds and
loads no kernel toolchain, its entry points refuse to fall back to the CPU
when asked for the card, and its docstring examples run."""

import ast
import doctest
import importlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    for p in PORT.rglob("*.py") if p.name != "__init__.py")
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes", "triton")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_engine_imports_with_jax_blocked_and_builds_nothing():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "import repro_torch.serving.engine, repro_torch.launch.serve\n"
        "import repro_torch.kernels.ops, repro_torch.core\n"
        "import repro_torch.launch.train, repro_torch.training.train_step\n"
        "import repro_torch.kernels.flash_attention, repro_torch.kernels.quantize\n"
        "import repro_torch.core.compression, repro_torch.models.lm\n"
        "bad = [m for m in ('triton', 'repro_torch.kernels._build')\n"
        "       if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_without_a_device_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    from repro_torch.serving.engine import ContinuousBatchingEngine
    from repro_torch.serving.kv_cache import PagedKVCache
    from repro_torch.serving.tp_lm import TPServeConfig

    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingEngine(TPServeConfig(), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCache(1, 2, 4, 1, 4, 1)
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.training.train_step import TrainConfig, make_train_step

    cfg = configs.get_reduced("llama3.2-1b")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(cfg)
    for mode in ("xla", "fmi"):
        with pytest.raises(RuntimeError, match="CUDA"):
            make_train_step(cfg, TrainConfig(mode=mode), make_host_mesh(2))
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "llama3.2-1b", "--reduced", "--steps", "1"])


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=_env(), capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails_without_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_launcher_dry_run_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-1.7b", "--dry-run", "--device", "cpu", "--tp", "2",
         "--attn", "kernel", "--kill-rank", "1", "--kill-at-step", "2",
         "--profile"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "healed: regrouped to world=1" in out.stdout
    assert "profile: wall" in out.stdout and "top host ops:" in out.stdout
    assert "dry-run ok" in out.stdout


@pytest.mark.parametrize("flags", [["--fleet", "2"],
                                   ["--batch-policy", "wave"]])
def test_launcher_refuses_unported_modes(flags):
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="not yet ported"):
        serve.main(["--arch", "qwen3-1.7b", "--device", "cpu", *flags])


@pytest.mark.parametrize("name", MODULES)
def test_module_doctests(name):
    mod = importlib.import_module(name)
    result = doctest.testmod(mod, optionflags=doctest.ELLIPSIS)
    assert result.failed == 0
