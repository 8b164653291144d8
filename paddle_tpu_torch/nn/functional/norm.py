"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``): ``batch_norm``, ``layer_norm``,
``instance_norm``, ``group_norm``, ``normalize``,
``local_response_norm``.

Statistics are f32 and the output is cast back to the input's dtype, as
in the JAX package.  ``batch_norm`` in training updates the running
statistics in place, outside autograd, by Paddle's rule
``running = momentum * running + (1 - momentum) * batch`` with the
biased batch variance (``torch.nn.functional.batch_norm`` would update
with the unbiased one and the opposite momentum, so it is called with
no running tensors and normalizes only).  A forward that
``distributed.recompute`` replays in the backward runs inside
``recompute_replay()`` and leaves the running statistics as the first
run left them.  ``local_response_norm`` pads
the channel window ``(size-1)//2`` low and the rest high and divides
``alpha`` by ``size``, as the JAX package does (PyTorch pads the other
way for an even size).
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as tF

from ...amp.auto_cast import cast_inputs

__all__ = ["batch_norm", "layer_norm", "instance_norm", "group_norm",
           "normalize", "local_response_norm"]

_tls = threading.local()


@contextlib.contextmanager
def recompute_replay():
    """Marks a recomputed forward in this thread: batch norms in it do
    not update their running statistics a second time."""
    prev = getattr(_tls, "replay", False)
    _tls.replay = True
    try:
        yield
    finally:
        _tls.replay = prev


def _f32(t):
    return None if t is None else t.float()


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch norm over every axis but the channel one; in training (and
    without ``use_global_stats``) ``running_mean`` / ``running_var``
    are updated in place."""
    x, weight, bias = cast_inputs("batch_norm", x, weight, bias)
    channel_last = not data_format.startswith("NC") and x.dim() > 2
    a = x.movedim(-1, 1) if channel_last else x
    af = a.float()
    if training and not use_global_stats:
        if not getattr(_tls, "replay", False):
            _update_running(af, running_mean, running_var, momentum)
        out = tF.batch_norm(af, None, None, _f32(weight), _f32(bias),
                            training=True, eps=epsilon)
    else:
        out = tF.batch_norm(af, running_mean.float(), running_var.float(),
                            _f32(weight), _f32(bias), training=False,
                            eps=epsilon)
    out = out.to(x.dtype)
    return out.movedim(1, -1) if channel_last else out


@torch.no_grad()
def _update_running(af, running_mean, running_var, momentum):
    """Paddle's running update from the biased batch statistics of the
    channel-first f32 input."""
    axes = [i for i in range(af.dim()) if i != 1]
    var, mean = torch.var_mean(af, dim=axes, unbiased=False)
    # one op reads each running buffer, so a static Program that records
    # this update (a rider) reads the buffer when it runs
    running_mean.copy_(torch.add((1 - momentum) * mean, running_mean.float(),
                                 alpha=momentum).to(running_mean.dtype))
    running_var.copy_(torch.add((1 - momentum) * var, running_var.float(),
                                alpha=momentum).to(running_var.dtype))


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """Normalizes over the trailing ``normalized_shape`` dims in f32 and
    casts back to the input dtype, as the JAX ``layer_norm`` does."""
    x, weight, bias = cast_inputs("layer_norm", x, weight, bias)
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    shape = tuple(normalized_shape)
    out = tF.layer_norm(x.float(), shape, _f32(weight), _f32(bias), epsilon)
    return out.to(x.dtype)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Each (sample, channel) normalized over its spatial dims; the
    running statistics are not read or updated, as in the JAX
    package."""
    x, weight, bias = cast_inputs("instance_norm", x, weight, bias)
    channel_last = not data_format.startswith("NC")
    a = x.movedim(-1, 1) if channel_last else x
    out = tF.instance_norm(a.float(), None, None, _f32(weight), _f32(bias),
                           use_input_stats=True, eps=eps).to(x.dtype)
    return out.movedim(1, -1) if channel_last else out


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    x, weight, bias = cast_inputs("group_norm", x, weight, bias)
    channel_last = not data_format.startswith("NC")
    a = x.movedim(-1, 1) if channel_last else x
    out = tF.group_norm(a.float(), num_groups, _f32(weight), _f32(bias),
                        epsilon).to(x.dtype)
    return out.movedim(1, -1) if channel_last else out


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(||x||_p, epsilon)`` along ``axis``."""
    norm = (x.abs() ** p).sum(dim=axis, keepdim=True) ** (1.0 / p)
    return x / norm.clamp_min(epsilon)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha/size * sum of squares over a channel window) **
    beta``."""
    channel_last = not data_format.startswith("NC")
    ch_axis = x.dim() - 1 if channel_last else 1
    sq = x.float().square().movedim(ch_axis, -1)
    low = (size - 1) // 2
    padded = tF.pad(sq, (low, size - 1 - low))
    c = sq.shape[-1]
    win = sum(padded[..., i:i + c] for i in range(size))
    div = ((k + alpha * win / size) ** beta).movedim(-1, ch_axis)
    return (x / div).to(x.dtype)
