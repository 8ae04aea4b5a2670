"""Two entry points that put state on the CPU when the caller did not ask
for it, against the port's rule that entry points run on ``cuda`` unless
asked for the CPU: ``io``'s loaders given no executor (``load_vars``,
``load_params``, ``load_persistables`` and ``fluid.load``, whose
``executor=None`` is the reference's default) and
``models/transformer_nmt.py`` ``init_nmt_params`` without a device.  Both
now resolve the device as every other entry point does
(``kernels/_common.py`` ``resolve_device``): ``cuda`` with a card, the
"no CUDA device" error without one; a CPU executor (or ``device="cpu"``)
still loads onto the CPU.  This machine has no card, so the error shows."""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.models import transformer_nmt as nmt


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NO_CARD = "no CUDA device"


@pytest.fixture(autouse=True)
def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def saved(tmp_path):
    """A program with two persistables, saved as .npy files and as one
    ``fluid.save`` checkpoint."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[3], dtype="float32")
        fluid.layers.fc(x, 2)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    with fluid.scope_guard(scope):
        fluid.io.save_persistables(exe, str(tmp_path), main)
        fluid.save(main, str(tmp_path / "ckpt"))
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    return main, scope, names, tmp_path


@pytest.mark.parametrize("loader", ["load_vars", "load_params",
                                    "load_persistables"])
def test_a_loader_without_an_executor_raises_without_a_card(loader, saved):
    main, _, _, path = saved
    kw = {"predicate": lambda v: v.persistable} if loader == "load_vars" else {}
    with pytest.raises(RuntimeError, match=NO_CARD):
        getattr(fluid.io, loader)(None, str(path), main, scope=fluid.Scope(),
                                  **kw)


def test_fluid_load_without_an_executor_raises_without_a_card(saved):
    main, _, _, path = saved
    with fluid.scope_guard(fluid.Scope()):
        with pytest.raises(RuntimeError, match=NO_CARD):
            fluid.load(main, str(path / "ckpt"))


def test_a_cpu_executor_still_loads_onto_the_cpu(saved):
    main, scope, names, path = saved
    exe = fluid.Executor(fluid.CPUPlace())
    fresh = fluid.Scope()
    fluid.io.load_persistables(exe, str(path), main, scope=fresh)
    other = fluid.Scope()
    with fluid.scope_guard(other):
        fluid.load(main, str(path / "ckpt"), exe)
    for s in (fresh, other):
        for n in names:
            t = s.find_var(n)
            assert t.device.type == "cpu" and torch.equal(t, scope.find_var(n))


def test_init_nmt_params_resolves_its_device(monkeypatch):
    cfg = nmt.nmt_tiny_config()
    with pytest.raises(RuntimeError, match=NO_CARD):
        nmt.init_nmt_params(torch.Generator().manual_seed(0), cfg)
    seen = []

    def resolve(device):
        seen.append(device)
        return torch.device("cpu")

    monkeypatch.setattr(nmt, "resolve_device", resolve)
    params = nmt.init_nmt_params(torch.Generator().manual_seed(0), cfg)
    assert seen == [None]
    assert params["src_emb"].device.type == "cpu"
    explicit = nmt.init_nmt_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert seen == [None, "cpu"]
    np.testing.assert_array_equal(explicit["src_emb"].numpy(),
                                  params["src_emb"].numpy())
