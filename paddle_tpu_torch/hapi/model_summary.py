"""``summary`` and ``flops`` (counterpart of
``paddle_tpu/hapi/model_summary.py``).

Both run one eval-mode forward of zeros (batch dims of ``None`` / -1
are 1) on the network's device with forward hooks on the leaf layers.
``summary`` prints each leaf call's output shape and parameter count
(a layer called twice, like ResNet's shared ReLU, has two rows) and
returns the totals; ``flops`` counts convolutions (output elements x
``in_channels / groups`` x kernel size x 2) and ``Linear`` layers (2 x
input elements x ``out_features``), the JAX package's rules.
"""
from __future__ import annotations

import math

import torch

from ..device import current_device

__all__ = ["summary", "flops"]


def _leaves(net):
    return [(name, sub) for name, sub in net.named_sublayers()
            if not any(True for _ in sub.children())]


def _zeros(size, device):
    return torch.zeros([1 if s is None or s == -1 else int(s)
                        for s in size], dtype=torch.float32, device=device)


def _device(net):
    p = next(iter(net.parameters()), None)
    return p.device if p is not None else current_device()


def _eval_forward(net, inputs, hooks):
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(*inputs)
    finally:
        net.train(was_training)
        for h in hooks:
            h.remove()


def summary(net, input_size=None, dtypes=None, input=None):
    """Print each leaf layer call's output shape and parameter count;
    returns ``{"total_params", "trainable_params"}``."""
    rows = []
    hooks = []

    def register(layer, name):
        def hook(l, inputs, outputs):
            out = outputs[0] if isinstance(outputs, (tuple, list)) \
                else outputs
            shape = list(out.shape) if torch.is_tensor(out) else "?"
            n_params = sum(p.numel() for p in l._parameters.values()
                           if p is not None)
            rows.append((name or l.__class__.__name__,
                         l.__class__.__name__, shape, n_params))
        hooks.append(layer.register_forward_hook(hook))

    for name, sub in _leaves(net):
        register(sub, name)
    if input is not None:
        x = list(input) if isinstance(input, (list, tuple)) else [input]
    else:
        if input_size is None:
            raise ValueError("summary needs input_size or input")
        sizes = input_size if isinstance(input_size, list) and \
            isinstance(input_size[0], (list, tuple)) else [input_size]
        dev = _device(net)
        x = [_zeros(size, dev) for size in sizes]
    _eval_forward(net, x, hooks)

    total = sum(p.numel() for p in net.parameters())
    trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)
    width = 72
    print("-" * width)
    print(f"{'Layer (type)':<32}{'Output Shape':<24}{'Param #':<12}")
    print("=" * width)
    for name, cls, shape, n in rows:
        print(f"{name + ' (' + cls + ')':<32}{str(shape):<24}{n:<12}")
    print("=" * width)
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    print("-" * width)
    return {"total_params": total, "trainable_params": trainable}


def _conv_flops(layer, inp, out):
    k = math.prod(layer._kernel_size)
    cin = layer._in_channels // layer._groups
    return out.numel() * cin * k * 2


def _linear_flops(layer, inp, out):
    return 2 * inp.numel() * layer._out_features


def flops(net, input_size, custom_ops=None, print_detail=False):
    """The forward's floating-point operations for one input of
    ``input_size`` (multiply-adds of convolutions and linears x 2;
    ``custom_ops`` maps a layer class to ``fn(layer, input, output)``)."""
    total = [0]
    hooks = []

    def hook(l, inputs, outputs):
        out = outputs[0] if isinstance(outputs, (tuple, list)) else outputs
        inp = inputs[0]
        cls = l.__class__.__name__
        if custom_ops and type(l) in custom_ops:
            total[0] += custom_ops[type(l)](l, inp, out)
        elif cls.startswith("Conv"):
            total[0] += _conv_flops(l, inp, out)
        elif cls == "Linear":
            total[0] += _linear_flops(l, inp, out)

    for _, sub in _leaves(net):
        hooks.append(sub.register_forward_hook(hook))
    _eval_forward(net, [_zeros(input_size, _device(net))], hooks)
    return total[0]
