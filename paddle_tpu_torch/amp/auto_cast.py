"""``auto_cast`` (counterpart of ``paddle_tpu/amp/auto_cast.py``).

Paddle's per-op casting with the JAX package's white and black lists:
inside ``auto_cast(dtype=...)`` each functional of ``nn.functional``
casts its inputs by its op name at entry (``cast_inputs``), as the JAX
tape does in ``core.autograd.apply``: an op on the black list runs on
f32 inputs, one on the white list (or any op at level ``'O2'``) on
bf16 / fp16 inputs made from its f32 ones, any other op as it is given.
This is not ``torch.autocast``: its op lists are PyTorch's, and it casts
inside the ops.  Plain tensor arithmetic (``x + y``) promotes as in the
JAX package (bf16 + f32 is f32).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Set

import torch

__all__ = ["auto_cast", "amp_guard", "amp_state", "white_list",
           "black_list", "decorate", "cast_inputs"]

WHITE_LIST: Set[str] = {
    "conv2d", "conv1d", "conv3d", "conv2d_transpose", "matmul", "matmul_v2",
    "mul", "linear", "einsum", "bmm", "flash_attention",
    "scaled_dot_product_attention", "lstm", "gru", "rnn_tanh", "rnn_relu",
}
BLACK_LIST: Set[str] = {
    "exp", "square", "log", "mean", "sum", "cos_sim", "softmax",
    "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
    "cross_entropy", "cross_entropy2", "log_softmax", "binary_cross_entropy",
    "bce_with_logits", "nll_loss", "kl_div", "layer_norm", "batch_norm",
    "group_norm", "instance_norm", "rms_norm", "reduce_mean", "reduce_sum",
    "mse_loss", "l1_loss", "smooth_l1_loss", "ctc_loss", "cumsum",
    "softplus", "erf", "pow", "norm",
}

_tls = threading.local()


class _AmpState:
    __slots__ = ("enabled", "dtype", "level", "white", "black")

    def __init__(self, enabled, dtype, level, white, black):
        self.enabled = enabled
        self.dtype = dtype
        self.level = level
        self.white = white
        self.black = black


def amp_state() -> Optional[_AmpState]:
    return getattr(_tls, "amp", None)


def white_list():
    return set(WHITE_LIST)


def black_list():
    return set(BLACK_LIST)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """Per-op casting in this thread: level ``'O1'`` casts by the lists,
    ``'O2'`` casts every op not on the black list."""
    d = torch.bfloat16 if str(dtype) in ("bfloat16", "bf16",
                                         "torch.bfloat16") \
        else torch.float16
    white = set(WHITE_LIST)
    black = set(BLACK_LIST)
    if custom_white_list:
        white |= set(custom_white_list)
        black -= set(custom_white_list)
    if custom_black_list:
        black |= set(custom_black_list)
        white -= set(custom_black_list)
    prev = amp_state()
    _tls.amp = _AmpState(bool(enable), d, level, white, black)
    try:
        yield
    finally:
        _tls.amp = prev


amp_guard = auto_cast


def cast_inputs(name: str, *args):
    """``args`` cast for op ``name`` under the thread's auto_cast state
    (unchanged outside one); non-floating values pass through."""
    st = getattr(_tls, "amp", None)
    if st is None or not st.enabled:
        return args

    def is_float(a):
        return torch.is_tensor(a) and a.is_floating_point()

    if name in st.black:
        return tuple(a.float() if is_float(a) and a.dtype != torch.float32
                     else a for a in args)
    if name in st.white or st.level == "O2":
        return tuple(a.to(st.dtype) if is_float(a) and
                     a.dtype == torch.float32 else a for a in args)
    return args


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """Level ``'O2'`` casts the models' floating parameters to the amp
    dtype; ``'O1'`` leaves them."""
    model_list = list(models) if isinstance(models, (list, tuple)) \
        else [models]
    if level == "O2":
        for m in model_list:
            m.to(dtype=dtype)
    if optimizers is None:
        return models
    return models, optimizers
