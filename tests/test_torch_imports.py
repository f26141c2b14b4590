"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and not ``examples/quickstart_torch.py`` imports JAX
or the reference package, importing the port leaves JAX unloaded, and
its entry points default to the card and raise where there is none
(nothing falls back to the CPU)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_module_imports_neither_jax_nor_the_reference(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path} imports {bad}"


def test_fault_chaos_and_serve_modules_are_checked():
    """The fault-tolerance slice's modules are among the files held to
    import neither JAX nor the reference."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for rel in ("distributed/fault.py", "distributed/__init__.py",
                "testing/chaos.py", "launch/serve.py"):
        assert f"src/repro_torch/{rel}" in names


def test_importing_the_port_leaves_jax_unloaded():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.serving,"
            " repro_torch.kernels.ops, repro_torch.configs,"
            " repro_torch.models.ssd, repro_torch.testing,"
            " repro_torch.kernels.flash_attention,"
            " repro_torch.models.attention, repro_torch.models.transformer,"
            " repro_torch.models.model, repro_torch.launch.steps,"
            " repro_torch.serving.frontend, repro_torch.distributed.fault,"
            " repro_torch.testing.chaos, repro_torch.launch.serve; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad; print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_default_device_is_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from repro_torch import resolve_device
    from repro_torch.core import EngineConfig, MorpheusEngine, TableSet
    from repro_torch.serving import ServeConfig, build_params, \
        make_synthetic_batch
    cfg = ServeConfig(n_layers=1)
    for call in (lambda: resolve_device(),
                 lambda: build_params(cfg),
                 lambda: make_synthetic_batch(cfg),
                 lambda: MorpheusEngine(None, TableSet([]), EngineConfig())):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_persistent_xla_cache_dir_raises():
    """Persistent XLA cache: the reference's ``xla_cache_dir`` has no
    PyTorch meaning, so setting it raises instead of being ignored."""
    from repro_torch.core import EngineConfig, MorpheusEngine, TableSet
    with pytest.raises(ValueError, match="xla_cache_dir"):
        MorpheusEngine(None, TableSet([]),
                       EngineConfig(xla_cache_dir="/tmp/x", device="cpu"))


def test_tf32_is_off_once_the_port_is_imported():
    import repro_torch  # noqa: F401
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
