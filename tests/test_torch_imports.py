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


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


DATA_PATH = ["runtime", "ft.retry", "dataset", "async_executor",
             "feed_pipe", "reader", "layers.io", "trainer",
             "tools.ctr_program", "datasets.flowers", "datasets.image",
             "datasets.mq2007", "datasets.sentiment", "datasets.voc2012",
             "datasets.wmt14"]


def test_the_data_path_is_checked_and_loads_alone():
    """Every module the data path added is among the files checked above,
    and importing all of them in a fresh interpreter loads neither JAX nor
    the JAX package; the native datafeed is built from the port's own
    source."""
    checked = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for mod in DATA_PATH:
        path = "paddle_tpu_torch/" + mod.replace(".", "/")
        assert path + ".py" in checked or path + "/__init__.py" in checked, mod
    assert (ROOT / "paddle_tpu_torch/runtime/datafeed.cc").exists()
    code = ("import sys\n" + "".join("import paddle_tpu_torch.%s\n" % m
                                      for m in DATA_PATH)
            + "print(sorted({m.split('.')[0] for m in sys.modules} & "
              "{'jax', 'jaxlib', 'paddle_tpu'}))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


DATA_PARALLEL = ["parallel", "parallel.mesh", "parallel.collectives",
                 "parallel.rules", "parallel.train", "parallel.zero",
                 "distributed", "distributed.fleet", "distributed.launch",
                 "distributed.role_maker", "ops.collective_ops",
                 "layers.collective", "dygraph.parallel"]


def test_the_data_parallel_engine_is_checked_and_loads_alone():
    """Every module of item 5-A is among the files checked above, and
    importing all of them in a fresh interpreter loads neither JAX nor the
    JAX package, nor initialises a process group."""
    checked = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for mod in DATA_PARALLEL:
        path = "paddle_tpu_torch/" + mod.replace(".", "/")
        assert path + ".py" in checked or path + "/__init__.py" in checked, mod
    code = ("import sys\n" + "".join("import paddle_tpu_torch.%s\n" % m
                                      for m in DATA_PARALLEL)
            + "import torch.distributed as dist\n"
            + "assert not dist.is_initialized()\n"
            + "print(sorted({m.split('.')[0] for m in sys.modules} & "
              "{'jax', 'jaxlib', 'paddle_tpu'}))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


SERVING_ONLINE = ["serving", "serving.queue", "serving.metrics",
                  "serving.shield", "serving.engine", "serving.canary",
                  "serving.lattice", "online", "online.stream",
                  "online.publish", "online.swap", "tools.serve_bench"]


def test_the_serving_tier_and_online_loop_are_checked_and_load_alone():
    """Every module of item 10-A and the online loop is among the files
    checked above, and importing all of them in a fresh interpreter loads
    neither JAX nor the JAX package."""
    checked = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for mod in SERVING_ONLINE:
        path = "paddle_tpu_torch/" + mod.replace(".", "/")
        assert path + ".py" in checked or path + "/__init__.py" in checked, mod
    code = ("import sys\n" + "".join("import paddle_tpu_torch.%s\n" % m
                                      for m in SERVING_ONLINE)
            + "print(sorted({m.split('.')[0] for m in sys.modules} & "
              "{'jax', 'jaxlib', 'paddle_tpu'}))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_serving_entry_points_run_on_the_card_unless_asked(monkeypatch):
    """Without a card, the exported predictor and the serve bench raise
    unless the CPU is named."""
    from paddle_tpu_torch.tools import serve_bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_bench.main(["--smoke"])


def test_fleet_init_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    """fleet.init() picks the card (and raises without one); with
    device="cpu" and no PADDLE_* endpoints a process runs alone."""
    from paddle_tpu_torch.distributed import fleet

    for k in ("PADDLE_TRAINER_ENDPOINTS", "PADDLE_TRAINERS_NUM"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet._Fleet().init()
    f = fleet._Fleet().init(device="cpu")
    assert f.device.type == "cpu" and f.worker_num() == 1
    assert not torch.distributed.is_initialized()


def test_data_path_entry_points_raise_without_a_card(monkeypatch):
    """Without a card, the Executor and a DataLoader given no place raise
    before they stage anything; with CPUPlace they run on the CPU."""
    import paddle_tpu_torch as fluid

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fluid.Executor()
    loader = fluid.DataLoader.from_generator(capacity=2)
    loader.set_batch_generator(lambda: iter([{"x": np.zeros(2)}]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        list(loader)
    loader.set_batch_generator(lambda: iter([{"x": np.zeros(2)}]),
                               places=fluid.CPUPlace())
    assert [b["x"].device.type for b in loader] == ["cpu"]


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


@pytest.mark.parametrize("name", ["learning_rate_decay", "LoDTensor",
                                  "LoDTensorArray", "Tensor"])
def test_compat_names_are_exported_as_the_jax_package_exports_them(name):
    """``lod`` and ``learning_rate_decay``, exported from the package root
    as ``paddle_tpu/__init__.py`` exports them."""
    import paddle_tpu
    import paddle_tpu_torch

    assert hasattr(paddle_tpu, name) and hasattr(paddle_tpu_torch, name)
    if name == "learning_rate_decay":
        from paddle_tpu_torch.layers import learning_rate_scheduler as sched

        mod = paddle_tpu_torch.learning_rate_decay
        assert mod.__all__ == paddle_tpu.learning_rate_decay.__all__
        assert all(getattr(mod, f) is getattr(sched, f) for f in mod.__all__)


def test_lod_tensor_round_trips_lengths_and_arrays():
    import paddle_tpu
    from paddle_tpu_torch import LoDTensor, LoDTensorArray, Tensor

    sides = []
    for cls in (LoDTensor, paddle_tpu.LoDTensor):
        t = cls()
        t.set(np.arange(12, dtype=np.float32).reshape(6, 2))
        t.set_recursive_sequence_lengths([[2, 3, 1]])
        sides.append((t.lod(), t.recursive_sequence_lengths(), t.shape(),
                      np.asarray(t, np.int64).tolist()))
    assert sides[0] == sides[1]
    assert sides[0][0] == [[0, 2, 5, 6]]
    assert Tensor is LoDTensor and isinstance(LoDTensorArray(), list)


TRANCHE_4 = ["ops.sequence_ops", "ops.ctc_ops", "ops.misc_ops4",
             "ops.misc_ops3", "ops.rnn_ops", "ops.pooling_ops",
             "ops.metric_ops", "ops.sampling_ops", "tools.programs",
             "tools.rule_cases", "tools.fp_bounds", "tools.profile_step"]


def test_tranche_4_and_the_crnn_path_are_checked_and_load_alone():
    """The op modules of item 3-B's tranche 4 (with ``ctc_align`` and
    ``edit_distance``) and the CRNN's program and profiling tools are among
    the files checked above, and importing all of them in a fresh
    interpreter loads neither JAX nor the JAX package."""
    checked = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for mod in TRANCHE_4:
        assert "paddle_tpu_torch/%s.py" % mod.replace(".", "/") in checked, mod
    code = ("import sys\n" + "".join("import paddle_tpu_torch.%s\n" % m
                                      for m in TRANCHE_4)
            + "print(sorted({m.split('.')[0] for m in sys.modules} & "
              "{'jax', 'jaxlib', 'paddle_tpu'}))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("op,ins", [
    ("warpctc", {"Logits": [np.zeros((1, 2, 3), np.float32)],
                 "Label": [np.array([[1]], np.int32)]}),
    ("edit_distance", {"Hyps": [np.array([[1, 2]], np.int32)],
                       "Refs": [np.array([[1]], np.int32)]}),
    ("ctc_align", {"Input": [np.array([[1, 1, 0]], np.int32)]}),
])
def test_the_crnn_rules_stay_on_their_tensors_device(op, ins):
    """A rule computes on the device its inputs lie on: on CPU tensors the
    outputs are CPU tensors (on CUDA tensors, CUDA ones; ``chip_smoke.py``
    phase 39 checks that), with no move between."""
    from paddle_tpu_torch.registry import OpLoweringContext, get_lowering

    outs = get_lowering(op)({k: [torch.from_numpy(a) for a in v]
                             for k, v in ins.items()}, {},
                            OpLoweringContext(None, torch.Generator()))
    assert {t.device.type for v in outs.values() for t in v} == {"cpu"}


TRANCHE_5 = ["ops.misc_ops", "ops.misc_ops2", "ops.misc_ops3",
             "ops.misc_ops4", "tools.rule_cases_5", "ir", "transpiler",
             "distributed", "distributed.transpiler", "install_check",
             "contrib.layers", "layers.extras", "tools.programs"]


def test_tranche_5_and_the_small_modules_are_checked_and_load_alone():
    """The op modules of item 3-B's tranche 5, ``ir``, the transpilers,
    ``install_check`` and ``contrib.layers`` are among the files checked
    above, and importing all of them in a fresh interpreter loads neither
    JAX nor the JAX package."""
    checked = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for mod in TRANCHE_5:
        path = "paddle_tpu_torch/%s" % mod.replace(".", "/")
        assert path + ".py" in checked or path + "/__init__.py" in checked, mod
    code = ("import sys\n" + "".join("import paddle_tpu_torch.%s\n" % m
                                      for m in TRANCHE_5)
            + "print(sorted({m.split('.')[0] for m in sys.modules} & "
              "{'jax', 'jaxlib', 'paddle_tpu'}))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("name", ["ir", "transpiler", "install_check",
                                  "distributed"])
def test_the_small_modules_are_exported_as_the_jax_package_exports_them(name):
    import paddle_tpu
    import paddle_tpu_torch

    assert hasattr(paddle_tpu, name) and hasattr(paddle_tpu_torch, name)
    assert getattr(paddle_tpu_torch, name).__name__ == "paddle_tpu_torch." + name


FAULT_TOLERANCE = ["ft.agree", "ft.policy", "ft.ckpt", "ft.guard",
                   "parallel.checkpoint", "tools.chaos_drill",
                   "tools.loop_drill"]


def test_the_fault_tolerance_layer_is_checked_and_loads_alone():
    """Every module of items 5-D and 6 is among the files checked above,
    and importing all of them in a fresh interpreter loads neither JAX nor
    the JAX package."""
    checked = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for mod in FAULT_TOLERANCE:
        assert "paddle_tpu_torch/%s.py" % mod.replace(".", "/") in checked, mod
    code = ("import sys\n" + "".join("import paddle_tpu_torch.%s\n" % m
                                      for m in FAULT_TOLERANCE)
            + "print(sorted({m.split('.')[0] for m in sys.modules} & "
              "{'jax', 'jaxlib', 'paddle_tpu'}))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_the_drills_run_on_the_card_unless_asked_for_the_cpu(monkeypatch,
                                                             tmp_path):
    """The port's drills default to the card: without one the chaos drill
    refuses (rc 2) and the loop drill's trainer raises, before either
    trains anything."""
    from paddle_tpu_torch.tools import chaos_drill, loop_drill

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chaos_drill.main(["--smoke", "--check"]) == 2
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop_drill.run("tiny", checkpoint=False)


HOSTPS = ["hostps", "hostps.table", "hostps.optimizer", "hostps.cache",
          "hostps.service", "hostps.wire", "hostps.shard_router",
          "tools.deepfm_hostps"]


def test_hostps_is_checked_and_loads_alone():
    """Every module of item 7 is among the files checked above, and
    importing all of them in a fresh interpreter loads neither JAX nor the
    JAX package, nor initialises CUDA (shard owners import them and must
    never touch a card)."""
    checked = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for mod in HOSTPS:
        path = "paddle_tpu_torch/" + mod.replace(".", "/")
        assert path + ".py" in checked or path + "/__init__.py" in checked, mod
    code = ("import sys\n" + "".join("import paddle_tpu_torch.%s\n" % m
                                      for m in HOSTPS)
            + "import torch\nassert not torch.cuda.is_initialized()\n"
            + "print(sorted({m.split('.')[0] for m in sys.modules} & "
              "{'jax', 'jaxlib', 'paddle_tpu'}))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_hostps_entry_points_raise_without_a_card(monkeypatch):
    """``HostPSEmbedding`` and ``HotRowCache`` with no device named mean the
    card; without one they raise, and run on the CPU only when asked."""
    from paddle_tpu_torch.hostps import (HostPSEmbedding, HostSparseTable,
                                         HotRowCache, service)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HostPSEmbedding(HostSparseTable(10, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HotRowCache(4, 2)
    svc = HostPSEmbedding(HostSparseTable(10, 2), cache_slots=2,
                          device="cpu")
    assert svc.pull(np.array([1])).device.type == "cpu"
    service._LIVE_EMBEDDINGS.discard(svc)


FLEET = ["serving.router", "serving.fleet", "runtime", "tools.chaos_drill",
         "tools.serve_bench"]


def test_the_fleet_and_the_c_api_are_checked_and_load_alone():
    """The router, the fleet, the C API's loader and the drills of item
    10-B are among the files checked above (and the C API's source embeds
    the port's inference module, not the JAX package's); importing them
    in a fresh interpreter loads neither JAX nor the JAX package, nor
    initialises CUDA."""
    checked = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for mod in FLEET:
        path = "paddle_tpu_torch/" + mod.replace(".", "/")
        assert path + ".py" in checked or path + "/__init__.py" in checked, mod
    src = (ROOT / "paddle_tpu_torch" / "runtime" / "capi.cc").read_text()
    assert '"paddle_tpu_torch.inference"' in src
    assert '"paddle_tpu.inference"' not in src
    code = ("import sys\n" + "".join("import paddle_tpu_torch.%s\n" % m
                                      for m in FLEET)
            + "import torch\nassert not torch.cuda.is_initialized()\n"
            + "print(sorted({m.split('.')[0] for m in sys.modules} & "
              "{'jax', 'jaxlib', 'paddle_tpu'}))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_a_replica_refuses_to_serve_without_a_card_unless_asked(
        monkeypatch, tmp_path):
    """``python -m paddle_tpu_torch.serving.fleet`` means the card: without
    one it raises before it loads anything or marks its inbox READY, and
    ``FleetManager`` passes the device it was given to every replica."""
    from paddle_tpu_torch.serving import FleetManager
    from paddle_tpu_torch.serving.fleet import replica_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--wire-dir", str(tmp_path / "w"), "--replica", "0",
            "--artifact", str(tmp_path / "missing"),
            "--mon-dir", str(tmp_path / "m"), "--feed", "x:4:float32"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replica_main(argv)
    assert not (tmp_path / "w").exists()
    # asked for the CPU, it gets past the device check (and fails on the
    # missing artifact instead)
    with pytest.raises(Exception) as exc:
        replica_main(argv + ["--device", "cpu"])
    assert "CUDA" not in str(exc.value)
    seen = []

    class _Proc:
        pid = 1

        def __init__(self, cmd, **kw):
            seen.append(cmd)

    monkeypatch.setattr("subprocess.Popen", _Proc)
    for device in ("cuda", "cpu"):
        FleetManager(str(tmp_path), "a", str(tmp_path), ["x:4:float32"],
                     device=device).spawn(0)
    assert [c[c.index("--device") + 1] for c in seen] == ["cuda", "cpu"]
    assert all(c[2] == "paddle_tpu_torch.serving.fleet" for c in seen)
