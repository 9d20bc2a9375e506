"""Import hygiene and device rules of the PyTorch port.

The port imports torch and numpy only: never ``jax`` and nothing of the
JAX package (``paddle1_tpu/__init__.py`` pulls in jax and the whole
tree). Its entry points run on CUDA unless the caller passes
``device="cpu"``; without a card that is a typed error.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

import paddle1_tpu_torch
from paddle1_tpu_torch.core.device import resolve_device
from paddle1_tpu_torch.core.errors import (DeviceUnavailableError,
                                           InvalidArgumentError)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(paddle1_tpu_torch.__file__)


def test_import_leaves_jax_and_the_jax_package_out():
    code = ("import sys, paddle1_tpu_torch, paddle1_tpu_torch.convert, "
            "paddle1_tpu_torch.ops.cuda.build, "
            "paddle1_tpu_torch.ops.flash_attention_bwd, "
            "paddle1_tpu_torch.ops.fused_adam, "
            "paddle1_tpu_torch.ops.fused_bn, "
            "paddle1_tpu_torch.ops.fused_bn_bwd, "
            "paddle1_tpu_torch.vision.models.resnet, "
            "paddle1_tpu_torch.nn.functional.pooling, "
            "paddle1_tpu_torch.text.models.bert, "
            "paddle1_tpu_torch.optimizer.optimizer, "
            "paddle1_tpu_torch.distributed.parallel_engine, "
            "paddle1_tpu_torch.core.async_loss, "
            "paddle1_tpu_torch.ops.math_ops, "
            "paddle1_tpu_torch.ops.manip_ops, "
            "paddle1_tpu_torch.ops.linalg_ops, "
            "paddle1_tpu_torch.ops.patch\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'paddle1_tpu.')) or "
            "m == 'paddle1_tpu')\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_distributed_imports_neither_jax_nor_the_jax_package():
    """The data-parallel slice: the process-group environment, the
    collectives, DataParallel, spawn, the mesh and the engine."""
    code = ("import sys\n"
            "import paddle1_tpu_torch.distributed as d\n"
            "import paddle1_tpu_torch.distributed.collective, "
            "paddle1_tpu_torch.distributed.env, "
            "paddle1_tpu_torch.distributed.parallel, "
            "paddle1_tpu_torch.distributed.spawn, "
            "paddle1_tpu_torch.distributed.topology\n"
            "assert d.ParallelEngine and d.DataParallel and d.spawn\n"
            "from paddle1_tpu_torch.nn import SyncBatchNorm\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'paddle1_tpu.')) or "
            "m == 'paddle1_tpu')\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_modules(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
    if f.endswith(".py")) + [os.path.join(ROOT, "chip_smoke.py")])
def test_no_source_file_imports_jax_or_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "paddle1_tpu"), (path, mod)


def test_resolve_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(DeviceUnavailableError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"
    with pytest.raises(InvalidArgumentError):
        resolve_device("tpu")


def test_entry_points_never_run_quietly_on_the_cpu(monkeypatch):
    from paddle1_tpu_torch.serving import CausalLM
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        CausalLM(16, d_model=8, nhead=2, num_layers=1, max_seq=8)
    lm = CausalLM(16, d_model=8, nhead=2, num_layers=1, max_seq=8,
                  device="cpu")
    assert all(p.device.type == "cpu" for p in lm.parameters())
    from paddle1_tpu_torch.text.models import BertModel
    small = dict(vocab_size=16, hidden_size=8, num_hidden_layers=1,
                 num_attention_heads=2, intermediate_size=16)
    with pytest.raises(DeviceUnavailableError):
        BertModel(**small)
    bert = BertModel(device="cpu", **small)
    assert all(p.device.type == "cpu" for p in bert.parameters())


def test_chip_smoke_refuses_to_run_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_conv_flags_default_to_the_card():
    from paddle1_tpu_torch.core import flags
    for name in ("fused_bn", "fused_bn_bwd", "conv_nhwc"):
        assert flags.flag(name) == "auto"
        assert flags.flag_active(name, torch.device("cuda", 0))
        assert not flags.flag_active(name, torch.device("cpu"))
    # the JAX package's 4 MiB crossover is a TPU measurement: on the
    # card every batch norm takes the kernel's wrapper, which raises on
    # an input outside the contract (C % 8, f16) instead of handing it
    # to the plain version
    with pytest.raises(InvalidArgumentError):
        flags.flag("fused_bn_auto_mb")
    from paddle1_tpu_torch.nn.functional.norm import fused_bn_active
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert fused_bn_active((8, 16), torch.bfloat16, cuda)
    assert fused_bn_active((8, 12), torch.float32, cuda)     # C % 8
    assert fused_bn_active((8, 16), torch.float16, cuda)
    assert not fused_bn_active((8, 16), torch.bfloat16, cpu)
    with flags.flags_guard(fused_bn="always"):
        assert fused_bn_active((8, 16), torch.float32, cpu)
        assert not fused_bn_active((8, 12), torch.float32, cpu)


def test_resnet_defaults_to_the_card(monkeypatch):
    from paddle1_tpu_torch.vision.models import resnet18
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        resnet18(num_classes=10)
    m = resnet18(num_classes=10, device="cpu")
    assert all(t.device.type == "cpu" for t in m.state_dict().values())


def test_eager_slice_imports_neither_jax_nor_the_jax_package():
    """The eager dygraph slice: the facade, autograd, save/load, LeNet and
    the softmax kernel's module."""
    code = ("import sys\n"
            "import paddle1_tpu_torch as p\n"
            "import paddle1_tpu_torch.core.tensor, "
            "paddle1_tpu_torch.core.dtype, paddle1_tpu_torch.core.place, "
            "paddle1_tpu_torch.core.generator, "
            "paddle1_tpu_torch.autograd.engine, "
            "paddle1_tpu_torch.autograd.py_layer, "
            "paddle1_tpu_torch.framework.io, "
            "paddle1_tpu_torch.ops.manip_ops, paddle1_tpu_torch.ops.softmax, "
            "paddle1_tpu_torch.vision.models.lenet\n"
            "assert p.to_tensor and p.Tensor and p.nn.functional.softmax\n"
            "assert p.vision.models.LeNet and p.autograd.PyLayer\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'paddle1_tpu.')) or "
            "m == 'paddle1_tpu')\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_lenet_and_to_tensor_default_to_the_card(monkeypatch):
    import paddle1_tpu_torch as p
    from paddle1_tpu_torch.vision.models import LeNet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        LeNet()
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        p.to_tensor([1.0])
    with pytest.raises(DeviceUnavailableError):
        p.set_device("gpu")
    m = LeNet(device="cpu")
    assert all(t.device.type == "cpu" for t in m.state_dict().values())
    t = p.to_tensor([1.0], place=p.CPUPlace())
    assert t.place == p.CPUPlace() and isinstance(t, p.Tensor)
