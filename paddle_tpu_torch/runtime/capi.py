"""A ctypes binding of the port's C inference API (``capi.cc`` / ``capi.h``):
what a C program does — a config, input tensors, ``PD_PredictorRun``, the
output tensors — from Python, for the tests and ``chip_smoke.py``.

``CPredictor(model_dir)`` runs on the card; ``CPredictor(model_dir,
use_gpu=False)`` calls ``PD_DisableGpu`` first.  ``run({name: array})``
returns the outputs as numpy arrays in fetch order and raises
``CAPIError`` with ``PD_LastError``'s text when the run returns false.
"""

import ctypes

import numpy as np

__all__ = ["CAPIError", "CPredictor", "library"]

# PD_DataType (capi.h)
_DTYPES = {np.dtype("float32"): 0, np.dtype("int32"): 1,
           np.dtype("int64"): 2, np.dtype("uint8"): 3}
_NUMPY = {v: k for k, v in _DTYPES.items()}

_P = ctypes.c_void_p
_SIGS = {
    "PD_NewAnalysisConfig": (_P, []),
    "PD_DeleteAnalysisConfig": (None, [_P]),
    "PD_SetModel": (None, [_P, ctypes.c_char_p, ctypes.c_char_p]),
    "PD_ModelDir": (ctypes.c_char_p, [_P]),
    "PD_DisableGpu": (None, [_P]),
    "PD_NewPaddleTensor": (_P, []),
    "PD_DeletePaddleTensor": (None, [_P]),
    "PD_SetPaddleTensorName": (None, [_P, ctypes.c_char_p]),
    "PD_SetPaddleTensorDType": (None, [_P, ctypes.c_int]),
    "PD_SetPaddleTensorShape": (None, [_P, ctypes.POINTER(ctypes.c_int),
                                       ctypes.c_int]),
    "PD_SetPaddleTensorData": (None, [_P, _P]),
    "PD_NewPaddleBuf": (_P, []),
    "PD_DeletePaddleBuf": (None, [_P]),
    "PD_PaddleBufReset": (None, [_P, _P, ctypes.c_size_t]),
    "PD_PaddleBufData": (_P, [_P]),
    "PD_PaddleBufLength": (ctypes.c_size_t, [_P]),
    "PD_PredictorRun": (ctypes.c_bool, [_P, _P, ctypes.c_int,
                                        ctypes.POINTER(_P),
                                        ctypes.POINTER(ctypes.c_int),
                                        ctypes.c_int]),
    "PD_GetOutputTensor": (_P, [_P, ctypes.c_int]),
    "PD_DeleteOutputTensors": (None, [_P, ctypes.c_int]),
    "PD_GetPaddleTensorName": (ctypes.c_char_p, [_P]),
    "PD_GetPaddleTensorDType": (ctypes.c_int, [_P]),
    "PD_GetPaddleTensorData": (_P, [_P]),
    "PD_GetPaddleTensorShape": (ctypes.POINTER(ctypes.c_int),
                                [_P, ctypes.POINTER(ctypes.c_int)]),
    "PD_LastError": (ctypes.c_char_p, []),
}

_lib = None


class CAPIError(RuntimeError):
    """``PD_PredictorRun`` returned false; the message is ``PD_LastError``."""


def library():
    """The built ``libcapi`` (``runtime.load("capi")``) with every entry's
    argument and result types set."""
    global _lib
    if _lib is None:
        from . import load

        lib = load("capi")
        if lib is None:
            raise RuntimeError("the C API is a native library and "
                               "PADDLE_TPU_NO_NATIVE is set")
        for name, (res, args) in _SIGS.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _lib = lib
    return _lib


class CPredictor:
    """One ``PD_AnalysisConfig`` over ``model_dir`` (its predictor is made
    at the first run and cached by the library)."""

    def __init__(self, model_dir, use_gpu=True):
        self.lib = library()
        self.cfg = self.lib.PD_NewAnalysisConfig()
        self.lib.PD_SetModel(self.cfg, str(model_dir).encode(), None)
        if not use_gpu:
            self.lib.PD_DisableGpu(self.cfg)

    def run(self, feed):
        lib = self.lib
        keep, tensors, bufs = [], [], []
        try:
            for name, value in feed.items():
                a = np.ascontiguousarray(value)
                if a.dtype not in _DTYPES:
                    raise TypeError("the C API takes %s, not %s"
                                    % (sorted(map(str, _DTYPES)), a.dtype))
                t = lib.PD_NewPaddleTensor()
                tensors.append(t)
                lib.PD_SetPaddleTensorName(t, name.encode())
                lib.PD_SetPaddleTensorDType(t, _DTYPES[a.dtype])
                shape = (ctypes.c_int * a.ndim)(*a.shape)
                lib.PD_SetPaddleTensorShape(t, shape, a.ndim)
                buf = lib.PD_NewPaddleBuf()
                bufs.append(buf)
                raw = ctypes.create_string_buffer(a.tobytes(), a.nbytes)
                keep.append(raw)            # borrowed by the buffer
                lib.PD_PaddleBufReset(buf, ctypes.cast(raw, _P), a.nbytes)
                lib.PD_SetPaddleTensorData(t, buf)
            # one input only: PD_Tensor is opaque, so a caller cannot lay
            # several out as the array PD_PredictorRun reads
            if len(tensors) != 1:
                raise ValueError("CPredictor.run takes one input tensor "
                                 "(PD_Tensor is opaque to its callers)")
            out, n = _P(), ctypes.c_int()
            if not lib.PD_PredictorRun(self.cfg, tensors[0], 1,
                                       ctypes.byref(out), ctypes.byref(n),
                                       int(np.shape(a)[0])):
                raise CAPIError(lib.PD_LastError().decode())
            try:
                return [self._output(lib.PD_GetOutputTensor(out, i))
                        for i in range(n.value)]
            finally:
                lib.PD_DeleteOutputTensors(out, n.value)
        finally:
            for t in tensors:
                lib.PD_DeletePaddleTensor(t)
            for b in bufs:                  # a tensor borrows its buffer
                lib.PD_DeletePaddleBuf(b)

    def _output(self, t):
        lib = self.lib
        nd = ctypes.c_int()
        shp = lib.PD_GetPaddleTensorShape(t, ctypes.byref(nd))
        shape = tuple(shp[i] for i in range(nd.value))
        dtype = _NUMPY[lib.PD_GetPaddleTensorDType(t)]
        buf = lib.PD_GetPaddleTensorData(t)
        raw = ctypes.string_at(lib.PD_PaddleBufData(buf),
                               lib.PD_PaddleBufLength(buf))
        return np.frombuffer(raw, dtype).reshape(shape).copy()

    def close(self):
        if self.cfg is not None:
            self.lib.PD_DeleteAnalysisConfig(self.cfg)
            self.cfg = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
