/* C inference API implementation of the port (see capi.h; counterpart of
 * paddle_tpu/runtime/capi.cc; parity:
 * paddle/fluid/inference/capi/{c_api.cc,pd_config.cc,pd_predictor.cc,
 * pd_tensor.cc}).
 *
 * The predictor behind PD_PredictorRun is
 * paddle_tpu_torch.inference.Predictor, reached through CPython: when
 * loaded inside a Python process the existing interpreter is used (GIL
 * acquired per call); when linked into a plain C program the first call
 * initializes an interpreter.  Predictors are cached per config, so
 * repeated PD_PredictorRun calls reuse the predictor and its executor's
 * plans.  The predictor runs on the card unless PD_DisableGpu was called
 * (AnalysisConfig.disable_gpu()); a predictor that cannot reach a card
 * raises, and the run returns false with that error in PD_LastError.    */

#include "capi.h"

#include <Python.h>

#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_last_error;

void set_error(const std::string& msg) { g_last_error = msg; }

void set_error_from_python() {
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  std::string msg = "python error";
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* u = PyUnicode_AsUTF8(s);
      if (u) msg = u;
      else PyErr_Clear();
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  set_error(msg);
}

const char* dtype_to_numpy(PD_DataType dt) {
  switch (dt) {
    case PD_FLOAT32: return "float32";
    case PD_INT32: return "int32";
    case PD_INT64: return "int64";
    case PD_UINT8: return "uint8";
    default: return nullptr;
  }
}

PD_DataType numpy_to_dtype(const char* name) {
  if (!strcmp(name, "float32")) return PD_FLOAT32;
  if (!strcmp(name, "int32")) return PD_INT32;
  if (!strcmp(name, "int64")) return PD_INT64;
  if (!strcmp(name, "uint8")) return PD_UINT8;
  return PD_UNKDTYPE;
}

size_t dtype_size(PD_DataType dt) {
  switch (dt) {
    case PD_FLOAT32: case PD_INT32: return 4;
    case PD_INT64: return 8;
    case PD_UINT8: return 1;
    default: return 0;
  }
}

struct GIL {
  PyGILState_STATE state;
  GIL() {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      /* release the GIL the init left held, else any OTHER thread's
       * PyGILState_Ensure would deadlock in a plain-C host program */
      PyEval_SaveThread();
    }
    state = PyGILState_Ensure();
  }
  ~GIL() { PyGILState_Release(state); }
};

}  // namespace

extern "C" {

/* -- PaddleBuf ---------------------------------------------------------- */

struct PD_PaddleBuf {
  void* data = nullptr;
  size_t length = 0;
  bool owned = false;
};

PD_PaddleBuf* PD_NewPaddleBuf() { return new PD_PaddleBuf(); }

void PD_DeletePaddleBuf(PD_PaddleBuf* buf) {
  if (!buf) return;
  if (buf->owned && buf->data) free(buf->data);
  delete buf;
}

void PD_PaddleBufResize(PD_PaddleBuf* buf, size_t length) {
  if (buf->owned && buf->data) free(buf->data);
  buf->data = malloc(length);
  buf->length = length;
  buf->owned = true;
}

void PD_PaddleBufReset(PD_PaddleBuf* buf, void* data, size_t length) {
  if (buf->owned && buf->data) free(buf->data);
  buf->data = data;
  buf->length = length;
  buf->owned = false;
}

bool PD_PaddleBufEmpty(PD_PaddleBuf* buf) { return buf->length == 0; }
void* PD_PaddleBufData(PD_PaddleBuf* buf) { return buf->data; }
size_t PD_PaddleBufLength(PD_PaddleBuf* buf) { return buf->length; }

/* -- Tensor ------------------------------------------------------------- */

struct PD_Tensor {
  std::string name;
  PD_DataType dtype = PD_FLOAT32;
  std::vector<int> shape;
  PD_PaddleBuf* buf = nullptr;   /* owned when owned_buf */
  bool owned_buf = false;
};

PD_Tensor* PD_NewPaddleTensor() { return new PD_Tensor(); }

void PD_DeletePaddleTensor(PD_Tensor* tensor) {
  if (!tensor) return;
  if (tensor->owned_buf && tensor->buf) PD_DeletePaddleBuf(tensor->buf);
  delete tensor;
}

void PD_SetPaddleTensorName(PD_Tensor* tensor, char* name) {
  tensor->name = name;
}

void PD_SetPaddleTensorDType(PD_Tensor* tensor, PD_DataType dtype) {
  tensor->dtype = dtype;
}

void PD_SetPaddleTensorData(PD_Tensor* tensor, PD_PaddleBuf* buf) {
  if (tensor->owned_buf && tensor->buf) PD_DeletePaddleBuf(tensor->buf);
  tensor->buf = buf;
  tensor->owned_buf = false;
}

void PD_SetPaddleTensorShape(PD_Tensor* tensor, int* shape, int size) {
  tensor->shape.assign(shape, shape + size);
}

const char* PD_GetPaddleTensorName(const PD_Tensor* tensor) {
  return tensor->name.c_str();
}

PD_DataType PD_GetPaddleTensorDType(const PD_Tensor* tensor) {
  return tensor->dtype;
}

PD_PaddleBuf* PD_GetPaddleTensorData(const PD_Tensor* tensor) {
  return tensor->buf;
}

int* PD_GetPaddleTensorShape(const PD_Tensor* tensor, int* size) {
  *size = static_cast<int>(tensor->shape.size());
  return const_cast<int*>(tensor->shape.data());
}

/* -- AnalysisConfig ----------------------------------------------------- */

struct PD_AnalysisConfig {
  std::string model_dir;
  std::string prog_file;
  std::string params_file;
  bool use_gpu = true;
  PyObject* predictor = nullptr;  /* cached paddle_tpu_torch Predictor */
};

PD_AnalysisConfig* PD_NewAnalysisConfig() { return new PD_AnalysisConfig(); }

void PD_DeleteAnalysisConfig(PD_AnalysisConfig* config) {
  if (!config) return;
  if (config->predictor) {
    GIL gil;
    Py_DECREF(config->predictor);
  }
  delete config;
}

static void invalidate_predictor(PD_AnalysisConfig* config) {
  if (config->predictor) {
    GIL gil;
    Py_DECREF(config->predictor);
    config->predictor = nullptr;
  }
}

void PD_SetModel(PD_AnalysisConfig* config, const char* model_dir,
                 const char* params_path) {
  config->model_dir = model_dir ? model_dir : "";
  config->params_file = params_path ? params_path : "";
  invalidate_predictor(config);
}

void PD_SetProgFile(PD_AnalysisConfig* config, const char* x) {
  config->prog_file = x ? x : "";
  invalidate_predictor(config);
}

void PD_SetParamsFile(PD_AnalysisConfig* config, const char* x) {
  config->params_file = x ? x : "";
  invalidate_predictor(config);
}

const char* PD_ModelDir(const PD_AnalysisConfig* config) {
  return config->model_dir.c_str();
}

void PD_DisableGpu(PD_AnalysisConfig* config) {
  if (!config->use_gpu) return;
  config->use_gpu = false;
  invalidate_predictor(config);
}

/* -- Predictor ---------------------------------------------------------- */

static PyObject* get_predictor(PD_AnalysisConfig* cfg) {
  if (cfg->predictor) return cfg->predictor;
  PyObject* mod = PyImport_ImportModule("paddle_tpu_torch.inference");
  if (!mod) return nullptr;
  PyObject* cfg_cls = PyObject_GetAttrString(mod, "AnalysisConfig");
  PyObject* pycfg = cfg_cls ? PyObject_CallFunction(
      cfg_cls, "sss",
      cfg->model_dir.c_str(),
      cfg->prog_file.empty() ? nullptr : cfg->prog_file.c_str(),
      cfg->params_file.empty() ? nullptr : cfg->params_file.c_str())
      : nullptr;
  if (pycfg && !cfg->use_gpu) {
    PyObject* r = PyObject_CallMethod(pycfg, "disable_gpu", NULL);
    if (r) {
      Py_DECREF(r);
    } else {
      Py_CLEAR(pycfg);
    }
  }
  PyObject* create = pycfg ? PyObject_GetAttrString(mod, "create_predictor")
                           : nullptr;
  PyObject* pred = create ? PyObject_CallFunctionObjArgs(create, pycfg, NULL)
                          : nullptr;
  Py_XDECREF(create);
  Py_XDECREF(pycfg);
  Py_XDECREF(cfg_cls);
  Py_DECREF(mod);
  cfg->predictor = pred;  /* may be null on error */
  return pred;
}

void PD_DeleteOutputTensors(PD_Tensor* arr, int n);

bool PD_PredictorRun(const PD_AnalysisConfig* config, PD_Tensor* inputs,
                     int in_size, PD_Tensor** output_data, int* out_size,
                     int batch_size) {
  (void)batch_size;
  GIL gil;
  PD_AnalysisConfig* cfg = const_cast<PD_AnalysisConfig*>(config);
  PyObject* pred = get_predictor(cfg);
  if (!pred) {
    set_error_from_python();
    return false;
  }
  PyObject* np = PyImport_ImportModule("numpy");
  if (!np) {
    set_error_from_python();
    return false;
  }

  bool ok = false;
  PyObject* feed = PyDict_New();
  PyObject* outs = nullptr;
  PyObject* names = nullptr;

  do {
    /* build feed dict: np.frombuffer(bytes, dtype).reshape(shape).copy() */
    bool feed_ok = true;
    for (int i = 0; i < in_size; i++) {
      PD_Tensor* t = &inputs[i];
      const char* dt = dtype_to_numpy(t->dtype);
      if (!dt || !t->buf) {
        set_error("input tensor '" + t->name + "' has no data/bad dtype");
        feed_ok = false;
        break;
      }
      PyObject* bytes = PyBytes_FromStringAndSize(
          static_cast<const char*>(t->buf->data),
          static_cast<Py_ssize_t>(t->buf->length));
      PyObject* arr = PyObject_CallMethod(np, "frombuffer", "Os", bytes, dt);
      Py_XDECREF(bytes);
      if (!arr) { feed_ok = false; break; }
      PyObject* shape = PyTuple_New(t->shape.size());
      for (size_t d = 0; d < t->shape.size(); d++) {
        PyTuple_SET_ITEM(shape, d, PyLong_FromLong(t->shape[d]));
      }
      PyObject* reshaped = PyObject_CallMethod(arr, "reshape", "O", shape);
      Py_DECREF(shape);
      Py_DECREF(arr);
      if (!reshaped) { feed_ok = false; break; }
      PyDict_SetItemString(feed, t->name.c_str(), reshaped);
      Py_DECREF(reshaped);
    }
    if (!feed_ok) break;

    outs = PyObject_CallMethod(pred, "run", "O", feed);
    if (!outs) break;
    names = PyObject_CallMethod(pred, "get_output_names", NULL);
    if (!names) break;

    Py_ssize_t n = PySequence_Length(outs);
    *out_size = static_cast<int>(n);
    PD_Tensor* out_arr = new PD_Tensor[n]();
    *output_data = out_arr;
    bool conv_ok = true;
    for (Py_ssize_t i = 0; i < n; i++) {
      PyObject* item = PySequence_GetItem(outs, i);
      PyObject* ascont = PyObject_CallMethod(
          np, "ascontiguousarray", "O", item);
      Py_XDECREF(item);
      if (!ascont) { conv_ok = false; break; }
      PD_Tensor* t = &out_arr[i];

      PyObject* nm = PySequence_GetItem(names, i);
      if (nm && PyUnicode_Check(nm)) {
        const char* nu = PyUnicode_AsUTF8(nm);
        if (nu) t->name = nu;
        else PyErr_Clear();
      }
      Py_XDECREF(nm);

      PyObject* dt = PyObject_GetAttrString(ascont, "dtype");
      PyObject* dts = dt ? PyObject_GetAttrString(dt, "name") : nullptr;
      const char* dtn = dts ? PyUnicode_AsUTF8(dts) : nullptr;
      if (!dtn) PyErr_Clear();
      t->dtype = dtn ? numpy_to_dtype(dtn) : PD_UNKDTYPE;
      Py_XDECREF(dts);
      Py_XDECREF(dt);

      PyObject* shp = PyObject_GetAttrString(ascont, "shape");
      if (shp) {
        Py_ssize_t nd = PyTuple_Size(shp);
        for (Py_ssize_t d = 0; d < nd; d++) {
          t->shape.push_back(static_cast<int>(
              PyLong_AsLong(PyTuple_GET_ITEM(shp, d))));
        }
        Py_DECREF(shp);
      }

      PyObject* bytes = PyObject_CallMethod(ascont, "tobytes", NULL);
      Py_DECREF(ascont);
      if (!bytes) { conv_ok = false; break; }
      char* data;
      Py_ssize_t len;
      PyBytes_AsStringAndSize(bytes, &data, &len);
      t->buf = PD_NewPaddleBuf();
      PD_PaddleBufResize(t->buf, static_cast<size_t>(len));
      memcpy(t->buf->data, data, static_cast<size_t>(len));
      t->owned_buf = true;
      Py_DECREF(bytes);
    }
    if (!conv_ok) {
      PD_DeleteOutputTensors(out_arr, static_cast<int>(n));
      *output_data = nullptr;
      *out_size = 0;
      break;
    }
    ok = true;
  } while (false);

  if (!ok && PyErr_Occurred()) set_error_from_python();
  Py_XDECREF(names);
  Py_XDECREF(outs);
  Py_XDECREF(feed);
  Py_XDECREF(np);
  return ok;
}

PD_Tensor* PD_GetOutputTensor(PD_Tensor* arr, int index) {
  return &arr[index];
}

void PD_DeleteOutputTensors(PD_Tensor* arr, int n) {
  if (!arr) return;
  for (int i = 0; i < n; i++) {
    if (arr[i].owned_buf && arr[i].buf) PD_DeletePaddleBuf(arr[i].buf);
    arr[i].buf = nullptr;
  }
  delete[] arr;
}

const char* PD_LastError() { return g_last_error.c_str(); }

}  /* extern "C" */
