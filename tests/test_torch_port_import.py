"""The port stands alone: no JAX, no JAX package, no CPU fallback.

- Every module of ``split_learning_tpu_torch`` (and ``chip_smoke.py``)
  imports in a fresh interpreter where ``jax``, ``flax`` and ``optax``
  cannot be imported. It must be a subprocess: tests/conftest.py
  imports jax into every test worker.
- No port file names ``jax``, ``flax``, ``optax``, ``split_learning_tpu``
  or ``scripts`` in an import statement.
- The two-party slice's modules (transport, obs, runtime.server,
  runtime.client, ops.quantize, ops.topk) import with jax blocked.
- Asking for CUDA on a machine without a GPU raises: the trainers, the
  server, the CLI and the kernel build never fall back to the CPU.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "split_learning_tpu_torch")
FORBIDDEN = ("jax", "flax", "optax", "split_learning_tpu", "scripts")


def _port_files():
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    yield os.path.join(REPO, "chip_smoke.py")


def _module_names():
    for path in _port_files():
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        yield rel[:-len(".__init__")] if rel.endswith(".__init__") else rel


def test_every_port_module_imports_without_jax():
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'optax'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for mod in {sorted(_module_names())!r}:\n"
        "    importlib.import_module(mod)\n"
        "leaked = sorted(m for m in sys.modules\n"
        "                if m == 'split_learning_tpu'\n"
        "                or m.startswith('split_learning_tpu.'))\n"
        "assert not leaked, leaked\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", list(_port_files()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in FORBIDDEN, (
                f"{os.path.relpath(path, REPO)}:{node.lineno} imports "
                f"{name}")


TWO_PARTY_MODULES = (
    "split_learning_tpu_torch.transport", "split_learning_tpu_torch.obs",
    "split_learning_tpu_torch.runtime.server",
    "split_learning_tpu_torch.runtime.client",
    "split_learning_tpu_torch.ops.quantize",
    "split_learning_tpu_torch.ops.topk")


def test_two_party_modules_import_without_jax():
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'optax', 'ml_dtypes'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for mod in {TWO_PARTY_MODULES!r}:\n"
        "    importlib.import_module(mod)\n"
        "from split_learning_tpu_torch.transport import codec\n"
        "import numpy as np\n"
        "d = codec.q8_compress(np.ones((2, 3), np.float32))\n"
        "assert codec.decompress_tree(codec.decode(codec.encode(d))).shape"
        " == (2, 3)\n"
        "leaked = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] == 'split_learning_tpu')\n"
        "assert not leaked, leaked\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


@pytest.fixture()
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU behaviour; this machine has a GPU")


def test_cuda_trainer_raises_without_gpu(no_gpu):
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime.fused import FusedSplitTrainer
    from split_learning_tpu_torch.utils.config import Config
    with pytest.raises(RuntimeError, match="cuda"):
        FusedSplitTrainer(get_plan(), Config(transport="fused"),
                          torch.Generator().manual_seed(0),
                          np.zeros((2, 28, 28, 1), np.float32))


def test_cli_defaults_to_cuda_and_raises_without_gpu(no_gpu, tmp_path):
    from split_learning_tpu_torch.launch.run import main
    with pytest.raises(RuntimeError, match="cuda"):
        main(["train", "--steps", "1", "--dataset", "synthetic",
              "--data-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())  # raised before touching data


def test_kernel_build_raises_without_nvcc(no_gpu, monkeypatch):
    import shutil

    from split_learning_tpu_torch.ops import common
    if shutil.which("nvcc"):
        pytest.skip("nvcc is installed here")
    monkeypatch.setattr(common, "_LOADED", {})
    monkeypatch.setattr(common, "BUILD_DIR",
                        common.BUILD_DIR.with_name("torch_kernels_absent"))
    with pytest.raises(RuntimeError, match="nvcc"):
        common.load_kernels()


def test_two_party_entry_points_raise_without_gpu(no_gpu):
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime import (
        ServerRuntime, SplitClientTrainer)
    from split_learning_tpu_torch.transport import LocalTransport
    from split_learning_tpu_torch.utils.config import Config
    with pytest.raises(RuntimeError, match="cuda"):
        ServerRuntime(get_plan(), Config(), torch.Generator().manual_seed(0))
    server = ServerRuntime(get_plan(), Config(),
                           torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        SplitClientTrainer(get_plan(), Config(),
                           torch.Generator().manual_seed(0),
                           LocalTransport(server))
