/* C inference API implementation: embeds CPython and drives
 * paddle_tpu_torch.inference.capi_bridge (create/run/destroy).
 *
 * Paddle's pd_predictor.cc wraps its C++ AnalysisPredictor; here the
 * predictor is jit.load's program (torch.export) on the GPU, and CPython
 * is the loader.  Only bytes + shapes + dtype names cross the C/Python
 * boundary (no numpy C API).
 */
#include "pd_inference.h"

#include <Python.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static char g_err[512];

static void set_err_from_py(const char *where) {
    PyObject *type = NULL, *value = NULL, *tb = NULL;
    PyErr_Fetch(&type, &value, &tb);
    PyObject *s = value ? PyObject_Str(value) : NULL;
    snprintf(g_err, sizeof(g_err), "%s: %s", where,
             s ? PyUnicode_AsUTF8(s) : "unknown python error");
    Py_XDECREF(s);
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
}

struct PD_Predictor {
    long long handle;
};

static PyObject *bridge(void) {
    /* import inside the GIL; cached by CPython's module registry */
    PyObject *m = PyImport_ImportModule("paddle_tpu_torch.inference.capi_bridge");
    if (!m) set_err_from_py("import paddle_tpu_torch.inference.capi_bridge");
    return m;
}

static int ensure_python(void) {
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
        if (!Py_IsInitialized()) {
            snprintf(g_err, sizeof(g_err), "Py_Initialize failed");
            return -1;
        }
    }
    return 0;
}

const char *PD_GetLastError(void) { return g_err; }

PD_Predictor *PD_NewPredictor(const char *model_path) {
    if (ensure_python() != 0) return NULL;
    PyGILState_STATE st = PyGILState_Ensure();
    PD_Predictor *out = NULL;
    PyObject *m = bridge();
    if (m) {
        PyObject *h = PyObject_CallMethod(m, "create", "s", model_path);
        if (h) {
            out = (PD_Predictor *)malloc(sizeof(PD_Predictor));
            out->handle = PyLong_AsLongLong(h);
            Py_DECREF(h);
        } else {
            set_err_from_py("PD_NewPredictor");
        }
        Py_DECREF(m);
    }
    PyGILState_Release(st);
    return out;
}

void PD_DeletePredictor(PD_Predictor *pred) {
    if (!pred) return;
    if (Py_IsInitialized()) {
        PyGILState_STATE st = PyGILState_Ensure();
        PyObject *m = bridge();
        if (m) {
            PyObject *r = PyObject_CallMethod(m, "destroy", "L",
                                              pred->handle);
            Py_XDECREF(r);
            Py_DECREF(m);
        }
        PyGILState_Release(st);
    }
    free(pred);
}

static int64_t numel(const PD_Tensor *t) {
    int64_t n = 1;
    for (int i = 0; i < t->ndim; i++) n *= t->shape[i];
    return n;
}

static int dtype_size(const char *name) {
    if (!strcmp(name, "float32") || !strcmp(name, "int32") ||
        !strcmp(name, "uint32")) return 4;
    if (!strcmp(name, "float64") || !strcmp(name, "int64") ||
        !strcmp(name, "uint64")) return 8;
    if (!strcmp(name, "float16") || !strcmp(name, "bfloat16") ||
        !strcmp(name, "int16")) return 2;
    if (!strcmp(name, "int8") || !strcmp(name, "uint8") ||
        !strcmp(name, "bool")) return 1;
    return -1;
}

int PD_PredictorRun(PD_Predictor *pred,
                    const PD_Tensor *inputs, int32_t n_inputs,
                    PD_Tensor **outputs, int32_t *n_outputs) {
    if (!pred || ensure_python() != 0) return -1;
    int rc = -1;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *m = NULL, *args_list = NULL, *res = NULL;

    m = bridge();
    if (!m) goto done;

    args_list = PyList_New(n_inputs);
    for (int i = 0; i < n_inputs; i++) {
        const PD_Tensor *t = &inputs[i];
        int isz = dtype_size(t->dtype);
        if (isz < 0 || t->ndim > PD_MAX_DIMS) {
            snprintf(g_err, sizeof(g_err),
                     "input %d: bad dtype %s or ndim %d", i, t->dtype,
                     t->ndim);
            goto done;
        }
        PyObject *raw = PyBytes_FromStringAndSize(
            (const char *)t->data, (Py_ssize_t)(numel(t) * isz));
        PyObject *shape = PyTuple_New(t->ndim);
        for (int d = 0; d < t->ndim; d++)
            PyTuple_SET_ITEM(shape, d, PyLong_FromLongLong(t->shape[d]));
        PyObject *dtype = PyUnicode_FromString(t->dtype);
        if (!raw || !shape || !dtype) {
            Py_XDECREF(raw);
            Py_XDECREF(shape);
            Py_XDECREF(dtype);
            set_err_from_py("PD_PredictorRun: input marshal");
            goto done;
        }
        PyObject *trip = PyTuple_Pack(3, raw, shape, dtype);
        Py_DECREF(raw);
        Py_DECREF(shape);
        Py_DECREF(dtype);
        PyList_SET_ITEM(args_list, i, trip); /* steals trip */
    }

    res = PyObject_CallMethod(m, "run", "LO", pred->handle, args_list);
    if (!res) {
        set_err_from_py("PD_PredictorRun");
        goto done;
    }

    {
        Py_ssize_t n = PyList_Size(res);
        PD_Tensor *outs = (PD_Tensor *)calloc((size_t)n,
                                              sizeof(PD_Tensor));
        for (Py_ssize_t i = 0; i < n; i++) {
            PyObject *trip = PyList_GetItem(res, i);     /* borrowed */
            PyObject *raw = PyTuple_GetItem(trip, 0);
            PyObject *shape = PyTuple_GetItem(trip, 1);
            PyObject *dtype = PyTuple_GetItem(trip, 2);
            PD_Tensor *t = &outs[i];
            Py_ssize_t ndim = PyTuple_Size(shape);
            if (ndim > PD_MAX_DIMS) {
                snprintf(g_err, sizeof(g_err),
                         "PD_PredictorRun: output %d has %d dims, more "
                         "than PD_MAX_DIMS (%d)", (int)i, (int)ndim,
                         PD_MAX_DIMS);
                PD_TensorsFree(outs, (int32_t)i);
                goto done;
            }
            t->ndim = (int32_t)ndim;
            for (int d = 0; d < t->ndim; d++)
                t->shape[d] = PyLong_AsLongLong(
                    PyTuple_GetItem(shape, d));
            snprintf(t->dtype, sizeof(t->dtype), "%s",
                     PyUnicode_AsUTF8(dtype));
            Py_ssize_t nbytes = PyBytes_Size(raw);
            t->data = malloc((size_t)nbytes);
            memcpy(t->data, PyBytes_AsString(raw), (size_t)nbytes);
        }
        *outputs = outs;
        *n_outputs = (int32_t)n;
        rc = 0;
    }

done:
    Py_XDECREF(res);
    Py_XDECREF(args_list);
    Py_XDECREF(m);
    PyGILState_Release(st);
    return rc;
}

void PD_TensorsFree(PD_Tensor *tensors, int32_t n) {
    if (!tensors) return;
    for (int i = 0; i < n; i++) free(tensors[i].data);
    free(tensors);
}

/* ---- training entry ---------------------------------------------------- */
struct PD_Trainer {
    long long handle;
};

PD_Trainer *PD_NewTrainer(const char *model_path) {
    if (ensure_python() != 0) return NULL;
    PyGILState_STATE st = PyGILState_Ensure();
    PD_Trainer *out = NULL;
    PyObject *m = bridge();
    if (m) {
        PyObject *h = PyObject_CallMethod(m, "create_trainer", "s",
                                          model_path);
        if (h) {
            out = (PD_Trainer *)malloc(sizeof(PD_Trainer));
            out->handle = PyLong_AsLongLong(h);
            Py_DECREF(h);
        } else {
            set_err_from_py("PD_NewTrainer");
        }
        Py_DECREF(m);
    }
    PyGILState_Release(st);
    return out;
}

/* No trainer handle exists while create_trainer raises: a step only
 * reports the bridge's reason (trainer_step raises it) and fails. */
int PD_TrainerStep(PD_Trainer *trainer,
                   const PD_Tensor *batch, int32_t n_batch,
                   float *loss_out) {
    (void)batch;
    (void)n_batch;
    (void)loss_out;
    if (ensure_python() != 0) return -1;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *m = bridge();
    if (m) {
        PyObject *r = PyObject_CallMethod(
            m, "trainer_step", "LO", trainer ? trainer->handle : -1LL,
            Py_None);
        Py_XDECREF(r);
        set_err_from_py("PD_TrainerStep");
        Py_DECREF(m);
    }
    PyGILState_Release(st);
    return -1;
}

void PD_DeleteTrainer(PD_Trainer *trainer) {
    if (!trainer) return;
    if (Py_IsInitialized()) {
        PyGILState_STATE st = PyGILState_Ensure();
        PyObject *m = bridge();
        if (m) {
            PyObject *r = PyObject_CallMethod(m, "destroy_trainer", "L",
                                              trainer->handle);
            Py_XDECREF(r);
            Py_DECREF(m);
        }
        PyGILState_Release(st);
    }
    free(trainer);
}
