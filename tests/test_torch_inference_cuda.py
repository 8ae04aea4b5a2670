"""The exported predictor's CUDA-graph route on the card: one captured graph
per feed signature, shared by every predictor over the artifact, each
predictor's weights copied into the graphs' buffers when it runs.  Every
test needs a card and skips without one; this file imports neither JAX nor
the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_inference_cuda.py

A small MLP program (fc 12 -> 16 tanh -> 5 softmax) stands in for a model:
the route does not depend on the ops.  Tolerance: the card against the
CPU's predictor over the same files, 1e-5 of the largest magnitude (f32,
TF32 off; cuBLAS and the CPU sum in other orders); a padded bucket's rows
bit for bit against a run of the padded batch."""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.ops import control_flow_ops
from paddle_tpu_torch.tools import programs


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.cuda
TOL = 1e-5


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU route)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture
def model_dir(tmp_path):
    """An MLP saved by save_inference_model and exported with a symbolic
    batch; returns (dir, startup weights of a second initialisation)."""
    d = str(tmp_path / "mlp")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[12], dtype="float32")
        h = fluid.layers.fc(x, 16, act="tanh")
        out = fluid.layers.fc(h, 5, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    scope, other = fluid.Scope(), fluid.Scope()
    exe.run(startup, scope=scope)
    startup.random_seed = 7
    exe.run(startup, scope=other)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(d, ["x"], [out], exe, main)
    fluid.inference.export_inference_model(d, {"x": (8, 12)}, poly_batch=True,
                                           device="cpu")
    names = [v.name for v in main.list_vars() if v.persistable]
    return d, {n: other.find_tensor_as_numpy(n) for n in names}


def _cpu(d):
    config = fluid.inference.AnalysisConfig(d)
    config.disable_gpu()
    return fluid.inference.create_predictor(config)


def _x(seed, n):
    return np.random.RandomState(seed).randn(n, 12).astype("f4")


def test_graphs_serve_buckets_without_new_captures(cuda_device, model_dir):
    d, _ = model_dir
    ep = fluid.inference.load_exported_model(d).declare_batch_buckets([1, 8, 32])
    assert ep.device.type == "cuda"
    for b in (1, 8, 32):
        assert ep.ensure_compiled({"x": ((b, 12), "float32")})[0] in (
            "compiled", "cached")
    n = ep.compiled_signature_count()
    assert n == 3 and len(ep.capture_seconds()) == 3
    cpu = _cpu(d)
    for rows in (1, 2, 5, 8, 9, 31, 32):
        x = _x(rows, rows)
        assert _rel(ep.run([x])[0], cpu.run([x])[0]) <= TOL
    x = _x(3, 5)
    padded = np.concatenate([x, np.zeros((3, 12), "f4")])
    np.testing.assert_array_equal(ep.run([x])[0], ep.run([padded])[0][:5])
    assert ep.compiled_signature_count() == n


def test_predictors_over_one_artifact_share_graphs_not_weights(cuda_device,
                                                                model_dir):
    """Two predictors share each captured graph; each keeps its own weights,
    copied into the graphs' buffers when it runs, and swap_state moves only
    its own answers, with no new capture."""
    d, other = model_dir
    a = fluid.inference.load_exported_model(d)
    b = fluid.inference.load_exported_model(d)
    x = _x(0, 8)
    want_a = _cpu(d).run([x])[0]
    got_a = a.run([x])[0]
    assert _rel(got_a, want_a) <= TOL
    n = a.compiled_signature_count()
    assert b.swap_state(other) == 4
    got_b = b.run([x])[0]
    assert np.abs(got_b - got_a).max() > 1e-4
    np.testing.assert_array_equal(a.run([x])[0], got_a)       # a's again
    np.testing.assert_array_equal(b.run([x])[0], got_b)
    assert a.compiled_signature_count() == b.compiled_signature_count() == n
    with pytest.raises(ValueError, match="signature change"):
        a.swap_state({k: np.zeros((2, 2), "f4") for k in other})


def test_predictor_on_the_card_matches_the_cpu(cuda_device, model_dir):
    d, _ = model_dir
    pred = fluid.inference.create_predictor(fluid.inference.AnalysisConfig(d))
    assert pred._exe.device.type == "cuda"
    x = _x(5, 6)
    assert _rel(pred.run([x])[0], _cpu(d).run([x])[0]) <= TOL
    clone = pred.clone()
    for n in pred._scope.local_var_names():
        assert clone._scope.find_var(n).data_ptr() == pred._scope.find_var(n).data_ptr()


def test_while_decode_on_the_card_matches_the_cpu(cuda_device):
    T, B, K, V = 5, 2, 3, 7
    rng = np.random.RandomState(1)
    feed = {"lp": np.exp(rng.randn(T, B, K, V) * 0.5 - 1.0).astype("f4"),
            "ps": (np.where(np.arange(K)[None] == 0, 0.0, -1e9)
                   * np.ones((B, 1))).astype("f4"),
            "pi": np.full((B, K), -1, "i4")}
    sents = []
    for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
        main, startup, v = programs.while_beam_decode(fluid, T, B, K, V)
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe.run(startup, scope=scope)
        control_flow_ops.reset_host_syncs()
        sents.append(exe.run(main, feed=feed, fetch_list=[v["sent"]],
                             scope=scope)[0])
        assert control_flow_ops.host_syncs["while"] == T + 1
    np.testing.assert_array_equal(sents[1], sents[0])
