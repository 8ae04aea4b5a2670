/* C inference API of the port (counterpart of paddle_tpu/runtime/capi.h;
 * parity: paddle/fluid/inference/capi/c_api.h — the PD_AnalysisConfig /
 * PD_Tensor / PD_PredictorRun deployment surface; outputs come back as one
 * PD_Tensor array freed with PD_DeleteOutputTensors, the one departure
 * from the reference contract).
 *
 * The API fronts the port's Python inference stack
 * (paddle_tpu_torch.inference.Predictor over the executor) through an
 * embedded CPython — usable from a plain C program linked against
 * libcapi.so + libpython, or inside an existing Python process (the GIL
 * is acquired per call).  The predictor runs on the CUDA card; after
 * PD_DisableGpu it runs on the CPU.  Without a card and without that call,
 * PD_PredictorRun returns false and PD_LastError says that no CUDA device
 * is available.                                                         */

#ifndef PADDLE_TPU_TORCH_CAPI_H_
#define PADDLE_TPU_TORCH_CAPI_H_

#include <stdbool.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

#define PADDLE_CAPI_EXPORT __attribute__((visibility("default")))

enum PD_DataType { PD_FLOAT32, PD_INT32, PD_INT64, PD_UINT8, PD_UNKDTYPE };

typedef struct PD_PaddleBuf PD_PaddleBuf;
typedef struct PD_Tensor PD_Tensor;
typedef struct PD_AnalysisConfig PD_AnalysisConfig;

/* -- PaddleBuf ---------------------------------------------------------- */
PADDLE_CAPI_EXPORT PD_PaddleBuf* PD_NewPaddleBuf();
PADDLE_CAPI_EXPORT void PD_DeletePaddleBuf(PD_PaddleBuf* buf);
PADDLE_CAPI_EXPORT void PD_PaddleBufResize(PD_PaddleBuf* buf, size_t length);
PADDLE_CAPI_EXPORT void PD_PaddleBufReset(PD_PaddleBuf* buf, void* data,
                                          size_t length);
PADDLE_CAPI_EXPORT bool PD_PaddleBufEmpty(PD_PaddleBuf* buf);
PADDLE_CAPI_EXPORT void* PD_PaddleBufData(PD_PaddleBuf* buf);
PADDLE_CAPI_EXPORT size_t PD_PaddleBufLength(PD_PaddleBuf* buf);

/* -- Tensor ------------------------------------------------------------- */
PADDLE_CAPI_EXPORT PD_Tensor* PD_NewPaddleTensor();
PADDLE_CAPI_EXPORT void PD_DeletePaddleTensor(PD_Tensor* tensor);
PADDLE_CAPI_EXPORT void PD_SetPaddleTensorName(PD_Tensor* tensor, char* name);
PADDLE_CAPI_EXPORT void PD_SetPaddleTensorDType(PD_Tensor* tensor,
                                                enum PD_DataType dtype);
PADDLE_CAPI_EXPORT void PD_SetPaddleTensorData(PD_Tensor* tensor,
                                               PD_PaddleBuf* buf);
PADDLE_CAPI_EXPORT void PD_SetPaddleTensorShape(PD_Tensor* tensor, int* shape,
                                                int size);
PADDLE_CAPI_EXPORT const char* PD_GetPaddleTensorName(const PD_Tensor* tensor);
PADDLE_CAPI_EXPORT enum PD_DataType PD_GetPaddleTensorDType(
    const PD_Tensor* tensor);
PADDLE_CAPI_EXPORT PD_PaddleBuf* PD_GetPaddleTensorData(
    const PD_Tensor* tensor);
PADDLE_CAPI_EXPORT int* PD_GetPaddleTensorShape(const PD_Tensor* tensor,
                                                int* size);

/* -- AnalysisConfig ----------------------------------------------------- */
PADDLE_CAPI_EXPORT PD_AnalysisConfig* PD_NewAnalysisConfig();
PADDLE_CAPI_EXPORT void PD_DeleteAnalysisConfig(PD_AnalysisConfig* config);
PADDLE_CAPI_EXPORT void PD_SetModel(PD_AnalysisConfig* config,
                                    const char* model_dir,
                                    const char* params_path);
PADDLE_CAPI_EXPORT void PD_SetProgFile(PD_AnalysisConfig* config,
                                       const char* x);
PADDLE_CAPI_EXPORT void PD_SetParamsFile(PD_AnalysisConfig* config,
                                         const char* x);
PADDLE_CAPI_EXPORT const char* PD_ModelDir(const PD_AnalysisConfig* config);
/* Run the config's predictor on the CPU (AnalysisConfig.disable_gpu();
 * upstream Paddle's C API name).  The default is the CUDA card.         */
PADDLE_CAPI_EXPORT void PD_DisableGpu(PD_AnalysisConfig* config);

/* -- Predictor ---------------------------------------------------------- */
/* Runs the model at config's model_dir on `inputs`; *output_data receives
 * an array of *out_size PD_Tensor freed with PD_DeleteOutputTensors.
 * Returns true on success; on failure returns false and PD_LastError()
 * describes why.                                                        */
PADDLE_CAPI_EXPORT bool PD_PredictorRun(const PD_AnalysisConfig* config,
                                        PD_Tensor* inputs, int in_size,
                                        PD_Tensor** output_data,
                                        int* out_size, int batch_size);

/* Indexes into the tensor array returned via output_data (PD_Tensor is an
 * opaque type, so C callers cannot pointer-arithmetic into the array). */
PADDLE_CAPI_EXPORT PD_Tensor* PD_GetOutputTensor(PD_Tensor* arr, int index);

/* Frees the tensor array returned via PD_PredictorRun's output_data. */
PADDLE_CAPI_EXPORT void PD_DeleteOutputTensors(PD_Tensor* arr, int n);

PADDLE_CAPI_EXPORT const char* PD_LastError();

#ifdef __cplusplus
}  /* extern "C" */
#endif

#endif  /* PADDLE_TPU_TORCH_CAPI_H_ */
