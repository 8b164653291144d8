"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference; this package keeps its
module names and layouts and runs on one NVIDIA Hopper GPU.  Every
Pallas kernel on a ported path becomes a hand-written CUDA kernel
(``csrc/``, built at first use by ``ops._build``) with its plain PyTorch
version beside it; a CPU tensor runs the plain version, a CUDA tensor
the kernel or an error.  Entry points default to the CUDA device and
raise without one; pass ``device="cpu"`` to run on the CPU.

Ported so far: single-GPU GPT serving on the dense KV cache
(``models.gpt``, ``inference.engine``) with the flash-attention forward
and decode-attention kernels, and the single-GPU GPT training step
(``distributed.SpmdTrainer``: bf16 or fp16 AMP with dynamic loss
scaling, gradient merge, selective recompute, the skip / rollback
anomaly policies, checkpoints; ``optimizer``, ``io.DevicePrefetcher``,
the fused cross-entropy) with the flash-attention backward kernels, and
their telemetry (``observability``: the metrics registry, spans, capture
windows, the flight recorder, the stall watchdog, the step-kind
registry and HBM ledger, the doctor and the SLO monitor; ``profiler``:
``RecordEvent``, ``torch.profiler`` capture control, ``StepTimer``), and
GPT mixture of experts on both paths with every expert on the one GPU
(``distributed.moe``), the decoding API over the KV cache
(``text.decoding``: beam and greedy search, ``gather_tree``, Viterbi;
``nn.decode``: ``BeamSearchDecoder``, ``dynamic_decode``) and the whole
optimizer package (``optimizer``: ten update rules, fifteen schedules,
the parameter EMA; ``regularizer``; ``incubate``: LookAhead,
ModelAverage), and Paddle's layer API on one GPU (``nn.Layer`` and the
layer zoo, ``amp.auto_cast``, ``save`` / ``load``, ``io.DataLoader``,
``metric``, ``hapi.Model``), and vision on one GPU (``nn``'s
convolutions, pools and norms, ``vision.models``, ``vision.datasets``'
synthetic data, ``vision.transforms``, ``summary`` / ``flops``), and
the op library (``tensor``, re-exported here as ``paddle.concat`` and
so on, and bound as ``torch.Tensor`` methods under the names torch
lacks; ``linalg``) with row-sparse embedding gradients
(``core.selected_rows``, ``Embedding(sparse=True)``, sparse SGD and
lazy Adam) and ``io.InMemoryDataset``, and the program path
(``jit``: ``to_static``, ``save`` / ``load`` over ``torch.export``, the
attention kernels as ``torch.library`` custom ops; ``inference``:
``load_predictor`` and the C API; ``static``: Program, Executor,
``save`` / ``load_inference_model``; ``func``, ``extension``,
``onnx``), and the recurrent layers (``nn.LSTM``, ``nn.GRU``,
``nn.SimpleRNN``, their cells, ``nn.RNN`` / ``nn.BiRNN``) with
``text.datasets``, the C training entry
(``SpmdTrainer.export_train_step``, ``PD_NewTrainer``), the file
systems (``framework.fs``), ``distribution``, ``nn.utils.weight_norm``,
``utils.unique_name`` and ``callbacks``.
"""
from .tensor import *  # noqa: F401,F403
from .tensor import __all__ as _tensor_all
from .tensor import tensor_methods as _tensor_methods  # noqa: F401
from . import (amp, autograd, callbacks, core, device, distributed,
               distribution, extension, framework, func, hapi, incubate,
               inference, io, jit, linalg, metric, models, nn,
               observability, onnx, ops, optimizer, profiler, regularizer,
               static, tensor, testing, text, utils, vision)
from .autograd import (enable_grad, grad, is_grad_enabled, no_grad,
                       set_grad_enabled)
from .core.dtype import (bfloat16, bool_, float16, float32, float64,
                         get_default_dtype, int8, int16, int32, int64,
                         set_default_dtype, uint8)
from .core.random import set_seed as seed
from .core.tensor import Parameter, is_tensor, to_tensor
from .device import (CPUPlace, CUDAPlace, get_device, resolve_device,
                     set_device)
from .framework.io import load, save
from .hapi import Model, flops, summary
from .nn.layer_base import ParamAttr
from .static import InputSpec
from .static.program import disable_static, enable_static, in_static_mode


def in_dynamic_mode() -> bool:
    return not in_static_mode()

__all__ = [*_tensor_all, "amp", "autograd", "callbacks", "core", "device",
           "distributed", "distribution", "framework", "hapi", "incubate",
           "inference", "io", "linalg", "metric", "models", "nn", "tensor",
           "observability", "ops", "optimizer", "profiler", "regularizer",
           "extension", "func", "jit", "onnx", "static", "InputSpec",
           "enable_static", "disable_static", "in_static_mode",
           "in_dynamic_mode", "CPUPlace", "CUDAPlace",
           "resolve_device", "testing", "text", "utils", "vision", "Model",
           "summary", "flops", "ParamAttr",
           "Parameter", "save", "load", "seed",
           "set_device", "get_device", "no_grad", "enable_grad", "grad",
           "set_grad_enabled", "is_grad_enabled", "set_default_dtype",
           "get_default_dtype", "bool_", "uint8", "int8", "int16", "int32",
           "int64", "float16", "bfloat16", "float32", "float64"]
