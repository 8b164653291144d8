/* C inference API over the paddle.jit.save artifact.
 *
 * Paddle's pd_predictor.cc + paddle_c_api.h (PD_NewAnalysisConfig /
 * PD_PredictorRun family).  The predictor behind this header is the
 * torch.export program that paddle_tpu_torch.jit.load runs on the GPU
 * (its attention on the hand-written kernels), reached through an
 * embedded CPython.
 *
 * Contract:
 *  - PD_NewPredictor loads "<path>.pdmodel" + "<path>.pdiparams"
 *    (paddle.jit.save artifacts) on the GPU, or on the device the
 *    environment variable PD_INFERENCE_DEVICE names ("cpu").
 *    PYTHONPATH must let the embedded interpreter import
 *    paddle_tpu_torch and torch.
 *  - Inputs are caller-owned buffers; outputs are library-allocated and
 *    released with PD_TensorsFree.
 *  - All functions return NULL / nonzero on failure; PD_GetLastError
 *    returns a static description of the most recent failure.
 */
#ifndef PD_INFERENCE_H
#define PD_INFERENCE_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define PD_MAX_DIMS 8

typedef struct {
    void *data;               /* element buffer                      */
    int64_t shape[PD_MAX_DIMS];
    int32_t ndim;
    char dtype[16];           /* numpy name: "float32", "int32", ... */
} PD_Tensor;

typedef struct PD_Predictor PD_Predictor;

PD_Predictor *PD_NewPredictor(const char *model_path);
void PD_DeletePredictor(PD_Predictor *pred);

/* Runs the exported program. Returns 0 on success and fills *outputs
 * (malloc'd array of *n_outputs tensors, each with a malloc'd data
 * buffer). */
int PD_PredictorRun(PD_Predictor *pred,
                    const PD_Tensor *inputs, int32_t n_inputs,
                    PD_Tensor **outputs, int32_t *n_outputs);

void PD_TensorsFree(PD_Tensor *tensors, int32_t n);

/* Native TRAINING entry (Paddle's fluid/train/demo).  It waits for
 * SpmdTrainer.export_train_step: PD_NewTrainer returns NULL,
 * PD_TrainerStep returns -1, and PD_GetLastError says why. */
typedef struct PD_Trainer PD_Trainer;

PD_Trainer *PD_NewTrainer(const char *model_path);
int PD_TrainerStep(PD_Trainer *trainer,
                   const PD_Tensor *batch, int32_t n_batch,
                   float *loss_out);
void PD_DeleteTrainer(PD_Trainer *trainer);

const char *PD_GetLastError(void);

#ifdef __cplusplus
}
#endif

#endif /* PD_INFERENCE_H */
