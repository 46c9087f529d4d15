"""The port stands alone: no JAX, no JAX package, no CPU fallback.

- Every module of ``split_learning_tpu_torch`` (and ``chip_smoke.py``)
  imports in a fresh interpreter where ``jax``, ``flax``, ``optax`` and
  ``orbax`` cannot be imported. It must be a subprocess: tests/conftest.py
  imports jax into every test worker.
- No port file names ``jax``, ``flax``, ``optax``, ``orbax``,
  ``split_learning_tpu`` or ``scripts`` in an import statement.
- The two-party slice's modules (transport, obs, runtime.server,
  runtime.client, ops.quantize, ops.topk) import with jax blocked.
- The HTTP slice's modules (transport.http, transport.chaos,
  runtime.breaker, runtime.evaluate, launch.run) import with jax, flax,
  optax and ``requests`` blocked, and a loopback round trip runs.
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
FORBIDDEN = ("jax", "flax", "optax", "orbax", "split_learning_tpu",
             "scripts")


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
        "for name in ('jax', 'flax', 'optax', 'orbax', 'requests'):\n"
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


HTTP_MODULES = (
    "split_learning_tpu_torch.transport.http",
    "split_learning_tpu_torch.transport.chaos",
    "split_learning_tpu_torch.runtime.breaker",
    "split_learning_tpu_torch.runtime.evaluate",
    "split_learning_tpu_torch.obs.metrics",
    "split_learning_tpu_torch.launch.run")


def test_http_modules_import_without_jax_or_requests():
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'optax', 'requests', 'urllib3'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for mod in {HTTP_MODULES!r}:\n"
        "    importlib.import_module(mod)\n"
        "from split_learning_tpu_torch.transport import (\n"
        "    HttpTransport, SplitHTTPServer)\n"
        "class Rt:\n"
        "    def health(self):\n"
        "        return {'status': 'healthy', 'mode': 'split'}\n"
        "srv = SplitHTTPServer(Rt()).start()\n"
        "t = HttpTransport(srv.url, timeout=10)\n"
        "assert t.wait_ready(timeout=10)['mode'] == 'split'\n"
        "t.close()\n"
        "srv.stop()\n"
        "leaked = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] == 'split_learning_tpu')\n"
        "assert not leaked, leaked\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


CHECKPOINT_MODULES = (
    "split_learning_tpu_torch.runtime.checkpoint",
    "split_learning_tpu_torch.runtime.state",
    "split_learning_tpu_torch.interop",
    "split_learning_tpu_torch.data.datasets",
    "split_learning_tpu_torch.launch.run")


def test_checkpoint_modules_save_and_restore_without_jax(tmp_path):
    """The checkpoint slice with JAX, Orbax and ``ml_dtypes`` blocked: a
    state saves, its sidecar writes, both read back, and a prefetch
    runs."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'optax', 'orbax', 'ml_dtypes'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for mod in {CHECKPOINT_MODULES!r}:\n"
        "    importlib.import_module(mod)\n"
        "import torch\n"
        "from split_learning_tpu_torch.data import DevicePrefetch\n"
        "from split_learning_tpu_torch.runtime import checkpoint as ck\n"
        f"c = ck.Checkpointer({str(tmp_path)!r})\n"
        "c.save(1, {'w': torch.ones(3, dtype=torch.bfloat16)},\n"
        "       extras=ck.build_extras(1, 1, replay=[]))\n"
        "c.close()\n"
        "assert c.restore_raw(1)['w'].dtype == torch.bfloat16\n"
        f"assert ck.read_latest_extras({str(tmp_path)!r}, step=1)\n"
        "pf = DevicePrefetch([(torch.zeros(2), 0)], depth=1, device='cpu')\n"
        "assert len(list(pf)) == 1\n"
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


U_FED_MODULES = (
    "split_learning_tpu_torch.runtime.multi_client",
    "split_learning_tpu_torch.runtime.client",
    "split_learning_tpu_torch.runtime.server",
    "split_learning_tpu_torch.runtime.state",
    "split_learning_tpu_torch.interop")


def test_u_split_federated_and_multi_client_modules_import_without_jax():
    """The tenth slice's modules import with jax, flax, optax and
    ml_dtypes blocked, and run: one U-shaped step, one FedAvg round of
    two submissions, one multi-client round with a bottom sync."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'optax', 'ml_dtypes'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for mod in {U_FED_MODULES!r}:\n"
        "    importlib.import_module(mod)\n"
        "import threading\n"
        "import numpy as np, torch\n"
        "from split_learning_tpu_torch.interop import params_to_jax\n"
        "from split_learning_tpu_torch.models import get_plan\n"
        "from split_learning_tpu_torch.runtime import (\n"
        "    MultiClientSplitRunner, ServerRuntime, USplitClientTrainer)\n"
        "from split_learning_tpu_torch.transport import LocalTransport\n"
        "from split_learning_tpu_torch.utils.config import Config\n"
        "g = lambda: torch.Generator().manual_seed(0)\n"
        "x = np.zeros((2, 28, 28, 1), np.float32)\n"
        "y = np.zeros(2, np.int64)\n"
        "cfg = Config(mode='u_split')\n"
        "srv = ServerRuntime(get_plan(mode='u_split'), cfg, g(),\n"
        "                    device='cpu')\n"
        "c = USplitClientTrainer(get_plan(mode='u_split'), cfg, g(),\n"
        "                        LocalTransport(srv, compress='int8'),\n"
        "                        device='cpu')\n"
        "assert np.isfinite(c.train_step(x, y, 0))\n"
        "fed = ServerRuntime(get_plan(mode='federated'),\n"
        "                    Config(mode='federated', num_clients=2), g(),\n"
        "                    device='cpu')\n"
        "p = params_to_jax(fed.params)\n"
        "out = {}\n"
        "t = threading.Thread(target=lambda: out.setdefault(\n"
        "    'a', fed.aggregate(p, 0, 1.0, 1, num_examples=4)))\n"
        "t.start()\n"
        "out['b'] = fed.aggregate(p, 0, 1.0, 2)\n"
        "t.join(timeout=30)\n"
        "assert sorted(out) == ['a', 'b']\n"
        "split = ServerRuntime(get_plan(), Config(num_clients=2), g(),\n"
        "                      device='cpu')\n"
        "r = MultiClientSplitRunner(get_plan(), Config(num_clients=2), g(),\n"
        "    lambda i: LocalTransport(split), sync_bottoms_every=1,\n"
        "    device='cpu')\n"
        "assert all(np.isfinite(r.train_round([(x, y), (x, y)])))\n"
        "leaked = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] == 'split_learning_tpu')\n"
        "assert not leaked, leaked\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_u_split_federated_and_multi_client_raise_without_gpu(no_gpu):
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime import (
        FederatedClientTrainer, MultiClientSplitRunner, ServerRuntime,
        USplitClientTrainer)
    from split_learning_tpu_torch.transport import LocalTransport
    from split_learning_tpu_torch.utils.config import Config
    gen = torch.Generator().manual_seed(0)
    for mode in ("u_split", "federated"):
        with pytest.raises(RuntimeError, match="cuda"):
            ServerRuntime(get_plan(mode=mode), Config(mode=mode), gen)
    server = ServerRuntime(get_plan(mode="u_split"), Config(mode="u_split"),
                           gen, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        USplitClientTrainer(get_plan(mode="u_split"), Config(mode="u_split"),
                            gen, LocalTransport(server))
    with pytest.raises(RuntimeError, match="cuda"):
        FederatedClientTrainer(get_plan(mode="federated"),
                               Config(mode="federated"), gen,
                               LocalTransport(server))
    with pytest.raises(RuntimeError, match="cuda"):
        MultiClientSplitRunner(get_plan(), Config(num_clients=2), gen,
                               lambda i: LocalTransport(server))
