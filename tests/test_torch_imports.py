"""The port stands alone: no module of ``paddle_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and its entry points run
on the card or raise, never quietly on the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _port_files():
    return sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.append(node.args[0].value)
    return names


def test_port_files_exist():
    files = _port_files()
    assert (ROOT / "chip_smoke.py").exists()
    assert len(files) >= 10


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    bad = [n for n in _imported(path)
           if n.split(".")[0] in FORBIDDEN]
    assert not bad, "%s imports %s" % (path.relative_to(ROOT), bad)


MONITOR_STACK = ["monitor", "monitor.registry", "monitor.timeline",
                 "monitor.trace", "monitor.flight", "monitor.exporters",
                 "monitor.recompile", "monitor.session", "monitor.fleetscope",
                 "monitor.tracemesh", "monitor.watchtower", "monitor.memory",
                 "monitor.memscope", "monitor.sentinel", "profiler", "flags",
                 "ft", "ft.chaos", "ops.misc_ops5"]


def test_the_monitor_stack_is_checked_and_loads_alone():
    """Every module the monitor stack added is among the files checked
    above, and importing all of them in a fresh interpreter loads neither
    JAX nor the JAX package."""
    checked = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for mod in MONITOR_STACK:
        path = "paddle_tpu_torch/" + mod.replace(".", "/")
        assert path + ".py" in checked or path + "/__init__.py" in checked, mod
    code = ("import sys\n" + "".join("import paddle_tpu_torch.%s\n" % m
                                      for m in MONITOR_STACK)
            + "print(sorted({m.split('.')[0] for m in sys.modules} & "
              "{'jax', 'jaxlib', 'paddle_tpu'}))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no card, an entry point called without device='cpu' raises
    before it builds anything."""
    from paddle_tpu_torch.models import bert

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bert.build_bert_trainer(bert.bert_tiny_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bert.build_bert_trainer(bert.bert_tiny_config(), device="cuda")
    trainer = bert.build_bert_trainer(bert.bert_tiny_config(), device="cpu")
    assert trainer.device.type == "cpu"


def test_resnet_entry_point_raises_without_a_card(monkeypatch):
    from paddle_tpu_torch.models import resnet

    cfg = resnet.resnet_tiny_config()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet.build_resnet_trainer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet.build_resnet_trainer(cfg, device="cuda")
    assert resnet.build_resnet_trainer(cfg, device="cpu").device.type == "cpu"


def test_default_device_is_cuda(monkeypatch):
    from paddle_tpu_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device().type == "cuda"


def test_deepfm_entry_point_raises_without_a_card(monkeypatch):
    from paddle_tpu_torch.models import deepfm

    cfg = deepfm.deepfm_tiny_config()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepfm.build_deepfm_trainer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepfm.build_deepfm_trainer(cfg, device="cuda")
    trainer = deepfm.build_deepfm_trainer(cfg, device="cpu")
    assert trainer.device.type == "cpu"
    assert trainer.variant == "segment"


def test_nmt_entry_points_raise_without_a_card(monkeypatch):
    from paddle_tpu_torch._tree import tree_leaves
    from paddle_tpu_torch.models import transformer_nmt as nmt
    from paddle_tpu_torch.models.parity import nmt_copy_decode_parity

    cfg = nmt.nmt_tiny_config()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nmt.build_nmt_trainer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nmt.build_nmt_trainer(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nmt_copy_decode_parity()
    trainer = nmt.build_nmt_trainer(cfg, device="cpu")
    assert trainer.device.type == "cpu"
    assert {t.device.type for t in tree_leaves(trainer.state["params"])} == {"cpu"}


def test_tree_walks_lists_in_index_order_and_dicts_by_key():
    from paddle_tpu_torch._tree import tree_leaves, tree_map
    from paddle_tpu_torch.convert import params_from_numpy, params_to_numpy

    tree = {"b": [1, {"y": 2, "x": 3}], "a": 4, "mlp": [[5], 6]}
    assert tree_leaves(tree) == [4, 1, 3, 2, 5, 6]
    doubled = tree_map(lambda v, w: v + w, tree, tree)
    assert doubled == {"b": [2, {"y": 4, "x": 6}], "a": 8, "mlp": [[10], 12]}
    assert isinstance(doubled["b"], list)
    back = params_to_numpy(params_from_numpy(
        {"mlp": [{"w": np.ones((2, 3), np.float32)}]}, "cpu"))
    assert isinstance(back["mlp"], list) and back["mlp"][0]["w"].shape == (2, 3)
