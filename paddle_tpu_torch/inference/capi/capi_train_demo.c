/* Standalone C training demo (Paddle's fluid/train/demo/demo_trainer.cc:
 * load a saved train program, feed batches, watch the loss fall).
 *
 * Usage: pd_capi_train_demo <model_path> <n_features> <batch>
 * The model is SpmdTrainer.export_train_step's program of a regression
 * net (float32 inputs [batch, n_features], labels [batch, 1]); the demo
 * feeds one fixed synthetic batch (y = sum of x) for 20 steps, prints
 * the loss of each, and prints CAPI-TRAIN-OK when the last loss is
 * below the first.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "pd_inference.h"

int main(int argc, char **argv) {
    if (argc < 4) {
        fprintf(stderr, "usage: %s <model_path> <n_feat> <batch>\n",
                argv[0]);
        return 2;
    }
    const char *path = argv[1];
    int nf = atoi(argv[2]);
    int bs = atoi(argv[3]);

    PD_Trainer *tr = PD_NewTrainer(path);
    if (!tr) {
        fprintf(stderr, "load failed: %s\n", PD_GetLastError());
        return 1;
    }

    /* a fixed synthetic batch: y = sum(x) */
    float *x = (float *)malloc(sizeof(float) * (size_t)(bs * nf));
    float *y = (float *)malloc(sizeof(float) * (size_t)bs);
    for (int i = 0; i < bs; i++) {
        float s = 0.0f;
        for (int j = 0; j < nf; j++) {
            float v = (float)((i * 31 + j * 17) % 13) / 13.0f - 0.5f;
            x[i * nf + j] = v;
            s += v;
        }
        y[i] = s;
    }

    PD_Tensor batch[2];
    memset(batch, 0, sizeof(batch));
    batch[0].data = x;
    batch[0].ndim = 2;
    batch[0].shape[0] = bs;
    batch[0].shape[1] = nf;
    snprintf(batch[0].dtype, sizeof(batch[0].dtype), "float32");
    batch[1].data = y;
    batch[1].ndim = 2;
    batch[1].shape[0] = bs;
    batch[1].shape[1] = 1;
    snprintf(batch[1].dtype, sizeof(batch[1].dtype), "float32");

    float first = 0.0f, loss = 0.0f;
    for (int step = 0; step < 20; step++) {
        if (PD_TrainerStep(tr, batch, 2, &loss) != 0) {
            fprintf(stderr, "step failed: %s\n", PD_GetLastError());
            return 1;
        }
        if (step == 0) first = loss;
        printf("STEP %d loss %.6f\n", step, loss);
    }

    PD_DeleteTrainer(tr);
    free(x);
    free(y);
    if (!(loss < first)) {
        fprintf(stderr, "loss did not decrease: %.6f -> %.6f\n", first,
                loss);
        return 1;
    }
    printf("CAPI-TRAIN-OK first=%.6f last=%.6f\n", first, loss);
    return 0;
}
