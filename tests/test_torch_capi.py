"""The port's C inference API (``paddle_tpu_torch/runtime/capi.cc``),
driven through ctypes the way a C program would: config -> tensors ->
``PD_PredictorRun`` -> outputs.  The reference's ``test_capi_predictor_run``
and ``test_capi_error_reporting`` (tests/test_capi.py) against the port's
library, with ``PD_DisableGpu`` for the CPU; the model is saved by the JAX
package and the outputs are held to its executor within the reference's
rtol 1e-5 / atol 1e-6."""

import ctypes

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu_torch import runtime


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load_capi():
    lib = runtime.load("capi")
    lib.PD_NewAnalysisConfig.restype = ctypes.c_void_p
    lib.PD_SetModel.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_char_p]
    lib.PD_ModelDir.restype = ctypes.c_char_p
    lib.PD_ModelDir.argtypes = [ctypes.c_void_p]
    lib.PD_DisableGpu.argtypes = [ctypes.c_void_p]
    lib.PD_NewPaddleTensor.restype = ctypes.c_void_p
    lib.PD_SetPaddleTensorName.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.PD_SetPaddleTensorDType.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.PD_SetPaddleTensorShape.argtypes = [ctypes.c_void_p,
                                            ctypes.POINTER(ctypes.c_int),
                                            ctypes.c_int]
    lib.PD_SetPaddleTensorData.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.PD_NewPaddleBuf.restype = ctypes.c_void_p
    lib.PD_PaddleBufReset.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_size_t]
    lib.PD_PaddleBufData.restype = ctypes.c_void_p
    lib.PD_PaddleBufData.argtypes = [ctypes.c_void_p]
    lib.PD_PaddleBufLength.restype = ctypes.c_size_t
    lib.PD_PaddleBufLength.argtypes = [ctypes.c_void_p]
    lib.PD_PredictorRun.restype = ctypes.c_bool
    lib.PD_PredictorRun.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.c_int]
    lib.PD_GetPaddleTensorName.restype = ctypes.c_char_p
    lib.PD_GetPaddleTensorName.argtypes = [ctypes.c_void_p]
    lib.PD_GetPaddleTensorDType.restype = ctypes.c_int
    lib.PD_GetPaddleTensorDType.argtypes = [ctypes.c_void_p]
    lib.PD_GetPaddleTensorData.restype = ctypes.c_void_p
    lib.PD_GetPaddleTensorData.argtypes = [ctypes.c_void_p]
    lib.PD_GetPaddleTensorShape.restype = ctypes.POINTER(ctypes.c_int)
    lib.PD_GetPaddleTensorShape.argtypes = [ctypes.c_void_p,
                                            ctypes.POINTER(ctypes.c_int)]
    lib.PD_LastError.restype = ctypes.c_char_p
    lib.PD_GetOutputTensor.restype = ctypes.c_void_p
    lib.PD_GetOutputTensor.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.PD_DeleteOutputTensors.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.PD_DeletePaddleTensor.argtypes = [ctypes.c_void_p]
    lib.PD_DeleteAnalysisConfig.argtypes = [ctypes.c_void_p]
    return lib


def _jax_model(tmp_path):
    """The reference test's tiny model, saved by the JAX package; returns
    (model dir, input, the JAX executor's output on it)."""
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        x = jfluid.layers.data("x", shape=[4], dtype="float32")
        y = jfluid.layers.fc(x, 3, act="softmax", param_attr="capi_w",
                             bias_attr="capi_b")
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup)
    model_dir = str(tmp_path / "capi_model")
    jfluid.io.save_inference_model(model_dir, ["x"], [y], exe,
                                   main_program=main)
    xs = np.random.RandomState(0).rand(5, 4).astype("f4")
    (want,) = exe.run(main, feed={"x": xs}, fetch_list=[y])
    return model_dir, xs, np.asarray(want)


def _input(lib, xs, keep):
    tensor = ctypes.c_void_p(lib.PD_NewPaddleTensor())
    lib.PD_SetPaddleTensorName(tensor, b"x")
    lib.PD_SetPaddleTensorDType(tensor, 0)          # PD_FLOAT32
    shape = (ctypes.c_int * 2)(*xs.shape)
    lib.PD_SetPaddleTensorShape(tensor, shape, 2)
    buf = ctypes.c_void_p(lib.PD_NewPaddleBuf())
    data = xs.tobytes()
    cdata = ctypes.create_string_buffer(data, len(data))
    keep.append(cdata)                              # the buffer is borrowed
    lib.PD_PaddleBufReset(buf, cdata, len(data))
    lib.PD_SetPaddleTensorData(tensor, buf)
    return tensor


def _output(lib, out_arr, i, rows, cols):
    t0 = ctypes.c_void_p(lib.PD_GetOutputTensor(out_arr, i))
    assert lib.PD_GetPaddleTensorDType(t0) == 0     # PD_FLOAT32
    nshape = ctypes.c_int()
    shp = lib.PD_GetPaddleTensorShape(t0, ctypes.byref(nshape))
    assert [shp[k] for k in range(nshape.value)] == [rows, cols]
    obuf = ctypes.c_void_p(lib.PD_GetPaddleTensorData(t0))
    n = lib.PD_PaddleBufLength(obuf)
    raw = ctypes.string_at(lib.PD_PaddleBufData(obuf), n)
    return np.frombuffer(raw, "f4").reshape(rows, cols)


def test_capi_library_builds_from_the_ports_source():
    lib = _load_capi()
    info = runtime.build_info["capi"]
    assert "build/runtime/libcapi_" in info["path"]
    assert lib is runtime.load("capi")              # cached per process


def test_capi_predictor_run(tmp_path):
    model_dir, xs, want = _jax_model(tmp_path)
    lib = _load_capi()
    cfg = ctypes.c_void_p(lib.PD_NewAnalysisConfig())
    lib.PD_SetModel(cfg, model_dir.encode(), None)
    assert lib.PD_ModelDir(cfg).decode() == model_dir
    lib.PD_DisableGpu(cfg)

    keep = []
    tensor = _input(lib, xs, keep)
    out_arr = ctypes.c_void_p()
    out_size = ctypes.c_int()
    ok = lib.PD_PredictorRun(cfg, tensor, 1, ctypes.byref(out_arr),
                             ctypes.byref(out_size), 5)
    assert ok, lib.PD_LastError().decode()
    assert out_size.value == 1
    got = _output(lib, out_arr, 0, 5, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    # the second run reuses the cached predictor and gives the same bits
    out_arr2 = ctypes.c_void_p()
    out_size2 = ctypes.c_int()
    assert lib.PD_PredictorRun(cfg, tensor, 1, ctypes.byref(out_arr2),
                               ctypes.byref(out_size2), 5)
    assert _output(lib, out_arr2, 0, 5, 3).tobytes() == got.tobytes()
    lib.PD_DeleteOutputTensors(out_arr, out_size.value)
    lib.PD_DeleteOutputTensors(out_arr2, out_size2.value)
    lib.PD_DeletePaddleTensor(tensor)
    lib.PD_DeleteAnalysisConfig(cfg)


def test_capi_error_reporting(tmp_path):
    lib = _load_capi()
    cfg = ctypes.c_void_p(lib.PD_NewAnalysisConfig())
    lib.PD_SetModel(cfg, str(tmp_path / "nonexistent").encode(), None)
    lib.PD_DisableGpu(cfg)
    out_arr = ctypes.c_void_p()
    out_size = ctypes.c_int()
    tensor = ctypes.c_void_p(lib.PD_NewPaddleTensor())
    lib.PD_SetPaddleTensorName(tensor, b"x")
    ok = lib.PD_PredictorRun(cfg, tensor, 1, ctypes.byref(out_arr),
                             ctypes.byref(out_size), 1)
    assert not ok
    assert lib.PD_LastError()          # a message, not a crash
    lib.PD_DeletePaddleTensor(tensor)
    lib.PD_DeleteAnalysisConfig(cfg)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without a card")
def test_capi_without_a_card_refuses_unless_gpu_is_disabled(tmp_path):
    """No card and no PD_DisableGpu: the run returns false and says why;
    nothing runs on the CPU quietly.  The same config after
    PD_DisableGpu serves."""
    model_dir, xs, want = _jax_model(tmp_path)
    lib = _load_capi()
    cfg = ctypes.c_void_p(lib.PD_NewAnalysisConfig())
    lib.PD_SetModel(cfg, model_dir.encode(), None)
    keep = []
    tensor = _input(lib, xs, keep)
    out_arr = ctypes.c_void_p()
    out_size = ctypes.c_int()
    assert not lib.PD_PredictorRun(cfg, tensor, 1, ctypes.byref(out_arr),
                                   ctypes.byref(out_size), 5)
    assert "no CUDA device" in lib.PD_LastError().decode()
    assert out_size.value == 0 and not out_arr.value

    lib.PD_DisableGpu(cfg)
    assert lib.PD_PredictorRun(cfg, tensor, 1, ctypes.byref(out_arr),
                               ctypes.byref(out_size), 5), \
        lib.PD_LastError().decode()
    np.testing.assert_allclose(_output(lib, out_arr, 0, 5, 3), want,
                               rtol=1e-5, atol=1e-6)
    lib.PD_DeleteOutputTensors(out_arr, out_size.value)
    lib.PD_DeletePaddleTensor(tensor)
    lib.PD_DeleteAnalysisConfig(cfg)


def test_the_binding_runs_the_jax_saved_model_and_reports_errors(tmp_path):
    """``runtime.capi.CPredictor`` (what ``chip_smoke.py`` drives): the
    outputs of the JAX-saved model within the reference's tolerance, two
    runs bit for bit alike, and a failed run raised with PD_LastError's
    text."""
    from paddle_tpu_torch.runtime import capi

    model_dir, xs, want = _jax_model(tmp_path)
    pred = capi.CPredictor(model_dir, use_gpu=False)
    (got,) = pred.run({"x": xs})
    assert got.dtype == np.float32 and got.shape == (5, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert pred.run({"x": xs})[0].tobytes() == got.tobytes()
    pred.close()
    bad = capi.CPredictor(str(tmp_path / "nonexistent"), use_gpu=False)
    with pytest.raises(capi.CAPIError):
        bad.run({"x": xs})
    with pytest.raises(ValueError, match="one input"):
        bad.run({"x": xs, "y": xs})
