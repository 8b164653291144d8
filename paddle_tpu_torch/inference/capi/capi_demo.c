/* Standalone C serving demo: load a paddle.jit.save artifact and run it.
 *
 * Usage: pd_capi_demo <model_path> (<dtype> <d0xd1x...>)...
 * Each (dtype, shape) pair is one input, filled with a ramp: element i
 * is i * 0.1 (float32) or i % 1000 + 4 (int64 / int32).  Prints, for
 * each output, its dtype, element count, a checksum of its bytes (the
 * sum of its 32-bit words, word i weighted by i + 1, modulo 2^64) and
 * its first values, then CAPI-DEMO-OK: a program with no Python on its
 * command line serves the artifact.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "pd_inference.h"

static uint64_t checksum(const void *data, size_t nbytes) {
    const uint32_t *w = (const uint32_t *)data;
    uint64_t h = 0;
    for (size_t i = 0; i < nbytes / 4; i++) h += (uint64_t)w[i] * (i + 1);
    return h;
}

static int fill(PD_Tensor *t, const char *dtype, const char *shape) {
    memset(t, 0, sizeof(*t));
    snprintf(t->dtype, sizeof(t->dtype), "%s", dtype);
    int64_t numel = 1;
    const char *s = shape;
    while (*s && t->ndim < PD_MAX_DIMS) {
        char *end;
        t->shape[t->ndim] = strtoll(s, &end, 10);
        numel *= t->shape[t->ndim++];
        s = (*end == 'x') ? end + 1 : end;
        if (end == s && *s) return -1;
    }
    if (!strcmp(dtype, "float32")) {
        float *v = (float *)malloc(sizeof(float) * (size_t)numel);
        for (int64_t i = 0; i < numel; i++) v[i] = (float)i * 0.1f;
        t->data = v;
    } else if (!strcmp(dtype, "int64")) {
        int64_t *v = (int64_t *)malloc(sizeof(int64_t) * (size_t)numel);
        for (int64_t i = 0; i < numel; i++) v[i] = i % 1000 + 4;
        t->data = v;
    } else if (!strcmp(dtype, "int32")) {
        int32_t *v = (int32_t *)malloc(sizeof(int32_t) * (size_t)numel);
        for (int64_t i = 0; i < numel; i++) v[i] = (int32_t)(i % 1000 + 4);
        t->data = v;
    } else {
        return -1;
    }
    return 0;
}

static size_t itemsize(const char *dtype) {
    if (!strcmp(dtype, "float64") || !strcmp(dtype, "int64")) return 8;
    if (!strcmp(dtype, "float16") || !strcmp(dtype, "bfloat16")) return 2;
    if (!strcmp(dtype, "bool") || !strcmp(dtype, "int8") ||
        !strcmp(dtype, "uint8")) return 1;
    return 4;
}

int main(int argc, char **argv) {
    if (argc < 4 || (argc - 2) % 2) {
        fprintf(stderr, "usage: %s <model_path> (<dtype> <d0xd1...>)...\n",
                argv[0]);
        return 2;
    }
    int n_in = (argc - 2) / 2;
    PD_Tensor *in = (PD_Tensor *)calloc((size_t)n_in, sizeof(PD_Tensor));
    for (int i = 0; i < n_in; i++) {
        if (fill(&in[i], argv[2 + 2 * i], argv[3 + 2 * i]) != 0) {
            fprintf(stderr, "bad input %d: %s %s\n", i, argv[2 + 2 * i],
                    argv[3 + 2 * i]);
            return 2;
        }
    }

    PD_Predictor *pred = PD_NewPredictor(argv[1]);
    if (!pred) {
        fprintf(stderr, "load failed: %s\n", PD_GetLastError());
        return 1;
    }
    PD_Tensor *outs = NULL;
    int32_t n_outs = 0;
    if (PD_PredictorRun(pred, in, n_in, &outs, &n_outs) != 0) {
        fprintf(stderr, "run failed: %s\n", PD_GetLastError());
        return 1;
    }
    for (int t = 0; t < n_outs; t++) {
        int64_t numel = 1;
        for (int d = 0; d < outs[t].ndim; d++) numel *= outs[t].shape[d];
        printf("OUT %d dtype=%s numel=%lld checksum=%llu:", t,
               outs[t].dtype, (long long)numel,
               (unsigned long long)checksum(
                   outs[t].data, (size_t)numel * itemsize(outs[t].dtype)));
        if (!strcmp(outs[t].dtype, "float32")) {
            const float *v = (const float *)outs[t].data;
            for (int64_t i = 0; i < numel && i < 8; i++)
                printf(" %.6f", v[i]);
        }
        printf("\n");
    }
    PD_TensorsFree(outs, n_outs);
    for (int i = 0; i < n_in; i++) free(in[i].data);
    free(in);
    PD_DeletePredictor(pred);
    printf("CAPI-DEMO-OK\n");
    return 0;
}
