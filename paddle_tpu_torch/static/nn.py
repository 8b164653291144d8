"""``paddle.static.nn``: static-graph layer helpers (counterpart of
``paddle_tpu/static/nn.py``).

Each call creates its Parameters on the current device (the recorded
graph captures them) and applies its op.  An op written here as one
function goes through ``_op``: in static mode it is one recorded node,
which reads its inputs' shapes when the program runs (so a ``None``
batch dim stays free), and eagerly it is a plain call.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..nn import functional as F
from ..nn import initializer as I
from .control_flow import case, cond, switch_case, while_loop  # noqa: F401
from .helpers import create_parameter  # noqa: F401
from .program import Variable, default_main_program, in_static_mode, \
    maybe_record
from ..extension import py_func  # noqa: F401

__all__ = [
    "fc", "batch_norm", "embedding", "bilinear_tensor_product", "case",
    "cond", "conv2d", "conv2d_transpose", "conv3d", "conv3d_transpose",
    "create_parameter", "crf_decoding", "data_norm", "deform_conv2d",
    "group_norm", "instance_norm", "layer_norm", "multi_box_head", "nce",
    "prelu", "py_func", "row_conv", "spectral_norm", "switch_case",
    "while_loop", "sparse_embedding",
]


def _op(fn, *args):
    """``fn(*args)``, one node in static mode."""
    rec = maybe_record(fn, list(args))
    return rec if rec is not None else fn(*args)


def _shape(x):
    return tuple(x.decl_shape) if isinstance(x, Variable) else tuple(x.shape)


def _make_param(shape, dtype, attr, is_bias=False, default_init=None):
    return create_parameter(shape, dtype, attr=attr, is_bias=is_bias,
                            default_initializer=default_init)


def _act(out, act):
    return getattr(F, act)(out) if act else out


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """Paddle's ``fc``: flatten the trailing dims, matmul, bias, optional
    activation; a list of inputs is summed."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    out = None
    for xi in xs:
        shp = _shape(xi)
        in_f = int(np.prod(shp[num_flatten_dims:]))
        w = _make_param([in_f, size], xi.dtype, weight_attr)
        if len(shp) != 2 or num_flatten_dims != 1:
            xi = xi.flatten(num_flatten_dims)
        flat = F.linear(xi, w)
        out = flat if out is None else out + flat
    b = _make_param([size], xs[0].dtype, bias_attr, is_bias=True)
    if b is not None:
        out = out + b
    return _act(out, activation)


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32"):
    """Paddle's ``embedding`` (``lookup_table_v2``); ``is_sparse`` gives
    the table a row-sparse gradient."""
    w = _make_param(list(size), dtype, param_attr,
                    default_init=I.Normal(0.0, 1.0 / math.sqrt(size[1])))
    return F.embedding(input, w, padding_idx=padding_idx, sparse=is_sparse)


def sparse_embedding(input, size, padding_idx=None, param_attr=None,
                     dtype="float32"):
    """Paddle's ``sparse_embedding`` (the large-vocabulary table):
    ``embedding`` with the row-sparse gradient."""
    return embedding(input, size, is_sparse=True, padding_idx=padding_idx,
                     param_attr=param_attr, dtype=dtype)


def _conv_nd(x, num_filters, filter_size, nd, stride, padding, dilation,
             groups, param_attr, bias_attr, act, transpose=False,
             output_size=None):
    cin = _shape(x)[1]
    ks = [filter_size] * nd if isinstance(filter_size, int) \
        else list(filter_size)
    g = groups or 1
    wshape = ([cin, num_filters // g] if transpose
              else [num_filters, cin // g]) + ks
    fan_in = (cin // g) * int(np.prod(ks))
    bound = math.sqrt(1.0 / max(fan_in, 1))
    w = _make_param(wshape, x.dtype, param_attr,
                    default_init=I.Uniform(-bound, bound))
    b = _make_param([num_filters], x.dtype, bias_attr, is_bias=True)
    if transpose:
        fn = {2: F.conv2d_transpose, 3: F.conv3d_transpose}[nd]
        out = fn(x, w, b, stride=stride, padding=padding, groups=g,
                 output_size=output_size)
    else:
        fn = {2: F.conv2d, 3: F.conv3d}[nd]
        out = fn(x, w, b, stride=stride, padding=padding,
                 dilation=dilation, groups=g)
    return _act(out, act)


def conv2d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=None, param_attr=None, bias_attr=None,
           use_cudnn=True, act=None, name=None, data_format="NCHW"):
    return _conv_nd(input, num_filters, filter_size, 2, stride, padding,
                    dilation, groups, param_attr, bias_attr, act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=None, param_attr=None, bias_attr=None,
           use_cudnn=True, act=None, name=None, data_format="NCDHW"):
    return _conv_nd(input, num_filters, filter_size, 3, stride, padding,
                    dilation, groups, param_attr, bias_attr, act)


def conv2d_transpose(input, num_filters, output_size=None,
                     filter_size=None, padding=0, stride=1, dilation=1,
                     groups=None, param_attr=None, bias_attr=None,
                     use_cudnn=True, act=None, name=None,
                     data_format="NCHW"):
    if filter_size is None:
        raise ValueError("conv2d_transpose: filter_size is required "
                         "(output_size-only inference not supported)")
    return _conv_nd(input, num_filters, filter_size, 2, stride, padding,
                    dilation, groups, param_attr, bias_attr, act,
                    transpose=True, output_size=output_size)


def conv3d_transpose(input, num_filters, output_size=None,
                     filter_size=None, padding=0, stride=1, dilation=1,
                     groups=None, param_attr=None, bias_attr=None,
                     use_cudnn=True, act=None, name=None,
                     data_format="NCDHW"):
    if filter_size is None:
        raise ValueError("conv3d_transpose: filter_size is required")
    return _conv_nd(input, num_filters, filter_size, 3, stride, padding,
                    dilation, groups, param_attr, bias_attr, act,
                    transpose=True, output_size=output_size)


def batch_norm(input, act=None, is_test=False, momentum=0.9,
               epsilon=1e-5, param_attr=None, bias_attr=None,
               data_layout="NCHW", name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=True,
               use_global_stats=False):
    """Paddle's ``batch_norm``.  The moving statistics are persistable
    tensors: training records their momentum update as riders written
    back after every run, and the test path normalizes with them.  Batch
    or moving statistics are chosen by a captured flag tensor that
    ``Program.clone(for_test=True)`` reads as 0."""
    C = _shape(input)[1]
    dt = input.dtype
    dev = input.device
    w = _make_param([C], dt, param_attr, default_init=I.Constant(1.0))
    b = _make_param([C], dt, bias_attr, is_bias=True)
    training = not (is_test or use_global_stats)
    rm = torch.zeros((C,), dtype=dt, device=dev)
    rv = torch.ones((C,), dtype=dt, device=dev)
    rm.persistable = rv.persistable = True
    rm.var_name, rv.var_name = moving_mean_name, moving_variance_name
    fl = torch.tensor(1.0 if training else 0.0, device=dev)
    fl._bn_train_flag = True

    def fn(a, ww, bb, mm, vv, flg):
        shape = (1, -1) + (1,) * (a.dim() - 2)
        red = [0] + list(range(2, a.dim()))
        mu_b = a.mean(dim=red)
        var_b = ((a - mu_b.reshape(shape)) ** 2).mean(dim=red)
        use_batch = flg > 0.5
        mu = torch.where(use_batch, mu_b, mm)
        var = torch.where(use_batch, var_b, vv)
        out = (a - mu.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                    + epsilon)
        out = out * ww.reshape(shape) + bb.reshape(shape)
        return (out, momentum * mm + (1.0 - momentum) * mu,
                momentum * vv + (1.0 - momentum) * var)

    out, new_mm, new_vv = _op(
        fn, input, w if w is not None else torch.ones((C,), dtype=dt,
                                                      device=dev),
        b if b is not None else torch.zeros((C,), dtype=dt, device=dev),
        rm, rv, fl)
    if training:
        if in_static_mode() and isinstance(new_mm, Variable):
            default_main_program()._updates += [(rm, new_mm), (rv, new_vv)]
        else:
            with torch.no_grad():
                rm.copy_(new_mm)
                rv.copy_(new_vv)
    return _act(out, act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    shp = _shape(input)
    n = int(np.prod(shp[begin_norm_axis:]))
    dt = input.dtype
    w = _make_param([n], dt, param_attr,
                    default_init=I.Constant(1.0)) if scale else None
    b = _make_param([n], dt, bias_attr, is_bias=True) if shift else None

    def fn(a, *wb):
        ww = wb[0] if w is not None else None
        bb = wb[-1] if b is not None else None
        ax = list(range(begin_norm_axis, a.dim()))
        mu = a.mean(dim=ax, keepdim=True)
        var = ((a - mu) ** 2).mean(dim=ax, keepdim=True)
        out = (a - mu) * torch.rsqrt(var + epsilon)
        tail = a.shape[begin_norm_axis:]
        if ww is not None:
            out = out * ww.reshape(tail)
        if bb is not None:
            out = out + bb.reshape(tail)
        return out

    out = _op(fn, input, *[a for a in (w, b) if a is not None])
    return _act(out, act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None,
               bias_attr=None, act=None, data_layout="NCHW", name=None):
    C = _shape(input)[1]
    w = _make_param([C], input.dtype, param_attr,
                    default_init=I.Constant(1.0))
    b = _make_param([C], input.dtype, bias_attr, is_bias=True)
    return _act(F.group_norm(input, groups, epsilon=epsilon, weight=w,
                             bias=b), act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    C = _shape(input)[1]
    w = _make_param([C], input.dtype, param_attr,
                    default_init=I.Constant(1.0))
    b = _make_param([C], input.dtype, bias_attr, is_bias=True)
    return F.instance_norm(input, weight=w, bias=b, eps=epsilon)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=True, slot_dim=-1,
              summary_decay_0=0.9999999):
    """Paddle's ``data_norm`` (CTR feature normalization) by the
    accumulated batch size / sum / square-sum statistics, which train as
    parameters."""
    C = _shape(input)[-1]
    dt = input.dtype
    size = _make_param([C], dt, param_attr, default_init=I.Constant(1e4))
    total = _make_param([C], dt, param_attr, default_init=I.Constant(0.0))
    square = _make_param([C], dt, param_attr, default_init=I.Constant(1e4))
    if size is None:  # attr=False: fixed identity statistics
        dev = input.device
        size = torch.full((C,), 1e4, dtype=dt, device=dev)
        total = torch.zeros((C,), dtype=dt, device=dev)
        square = torch.full((C,), 1e4, dtype=dt, device=dev)

    def fn(a, n, s, sq):
        return (a - s / n) * torch.sqrt(n / sq.clamp_min(epsilon))

    return _act(_op(fn, input, size, total, square), act)


def prelu(x, mode="all", param_attr=None, name=None):
    """Paddle's ``prelu``: mode all (one slope), channel or element."""
    shp = _shape(x)
    if mode == "all":
        ashape = [1]
    elif mode == "channel":
        ashape = [shp[1]]
    elif mode == "element":
        ashape = list(shp[1:])
    else:
        raise ValueError(f"prelu mode {mode!r}")
    alpha = _make_param(ashape, x.dtype, param_attr,
                        default_init=I.Constant(0.25))
    if alpha is None:  # attr=False: Paddle's default slope
        alpha = torch.full(ashape, 0.25, dtype=x.dtype, device=x.device)

    def fn(a, al):
        if mode == "channel":
            al = al.reshape((1, -1) + (1,) * (a.dim() - 2))
        elif mode == "element":
            al = al.reshape((1,) + tuple(a.shape[1:]))
        return torch.where(a > 0, a, al * a)

    return _op(fn, x, alpha)


def row_conv(input, future_context_size, param_attr=None, act=None):
    """Paddle's ``row_conv`` (look-ahead convolution): ``out[t] =
    sum_{i=0..k} in[t+i] * w[i]`` over ``[B, T, D]``."""
    D = _shape(input)[-1]
    k = future_context_size
    w = _make_param([k + 1, D], input.dtype, param_attr)
    if w is None:
        raise ValueError("row_conv requires a weight parameter "
                         "(param_attr must not be False)")

    def fn(a, ww):
        T = a.shape[-2]
        ap = torch.nn.functional.pad(a, (0, 0, 0, k))
        out = 0.0
        for i in range(k + 1):
            out = out + ap[..., i:i + T, :] * ww[i]
        return out

    return _act(_op(fn, input, w), act)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """Paddle's ``spectral_norm``: ``w / sigma_max(w)`` by
    ``power_iters`` rounds of power iteration from fixed unit vectors."""
    def fn(w):
        wm = w.movedim(dim, 0)
        h = wm.shape[0]
        mat = wm.reshape(h, -1).float()
        u = torch.ones(h, device=w.device) / math.sqrt(h)
        v = None
        for _ in range(max(power_iters, 1)):
            v = mat.T @ u
            v = v / torch.linalg.norm(v).clamp_min(eps)
            u = mat @ v
            u = u / torch.linalg.norm(u).clamp_min(eps)
        sigma = u @ mat @ v
        return w / sigma.to(w.dtype)

    return _op(fn, weight)


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    """Paddle's ``bilinear_tensor_product``: ``out_k = x^T W_k y + b``."""
    dx, dy = _shape(x)[-1], _shape(y)[-1]
    w = _make_param([size, dx, dy], x.dtype, param_attr)
    if w is None:
        raise ValueError("bilinear_tensor_product requires a weight "
                         "parameter (param_attr must not be False)")
    b = _make_param([1, size], x.dtype, bias_attr, is_bias=True)

    def fn(xa, ya, wa, *rest):
        out = torch.einsum("bi,kij,bj->bk", xa, wa, ya)
        return out + rest[0] if rest else out

    out = _op(fn, x, y, w, *([b] if b is not None else []))
    return _act(out, act)


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=10, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """Noise-contrastive estimation loss (Paddle's ``nce``) with uniform
    negatives, drawn afresh on every run of the op (from a generator
    seeded by ``seed`` when it is not 0); per-sample loss ``[N, 1]``."""
    D = _shape(input)[-1]
    dt = input.dtype
    w = _make_param([num_total_classes, D], dt, param_attr)
    if w is None:
        raise ValueError("nce requires a weight parameter "
                         "(param_attr must not be False)")
    b = _make_param([num_total_classes], dt, bias_attr, is_bias=True)
    if b is None:
        b = torch.zeros((num_total_classes,), dtype=dt, device=input.device)
    k = num_neg_samples
    gen = None
    if seed:
        gen = torch.Generator(device=input.device)
        gen.manual_seed(int(seed))

    def fn(xa, lab, wa, ba):
        n = xa.shape[0]
        lab = lab.reshape(-1).long()
        neg = torch.randint(0, num_total_classes, (n, k), generator=gen,
                            device=xa.device)
        pos_logit = torch.einsum("nd,nd->n", xa, wa[lab]) + ba[lab]
        neg_logit = torch.einsum("nd,nkd->nk", xa, wa[neg]) + ba[neg]
        # uniform noise: P_noise = 1 / V, logit shift log(k * Pn)
        shift = math.log(k / num_total_classes)
        pos = torch.nn.functional.softplus(-(pos_logit - shift))
        negs = torch.nn.functional.softplus(neg_logit - shift).sum(1)
        return (pos + negs).reshape(-1, 1)

    return _op(fn, input, label, w, b)


def crf_decoding(input, param_attr=None, label=None, length=None,
                 transition=None):
    """Paddle's ``crf_decoding``: the Viterbi path under ``transition``
    (the ``linear_chain_crf`` parameter with its start / stop rows at
    [0] / [1]); with ``label``, the per-step correctness mask."""
    from ..text.decoding import viterbi_decode
    T = _shape(input)[-1]
    if transition is None:
        transition = _make_param([T + 2, T], input.dtype, param_attr)
    _, path = viterbi_decode(input, transition[2:], lengths=length,
                             include_bos_eos_tag=False)
    if label is not None:
        return (path == label.reshape(path.shape)).long()
    return path


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2),
                   flip=True, clip=False, kernel_size=1, pad=0,
                   stride=1, name=None, min_max_aspect_ratios_order=False):
    """SSD detection head (Paddle's ``multi_box_head``): per feature map a
    location and a confidence convolution, and the prior boxes.  Returns
    ``(mbox_locs [N, P, 4], mbox_confs [N, P, C], boxes [P, 4],
    variances [P, 4])``."""
    from ..tensor import concat
    from ..vision.ops import prior_box as _prior
    n_maps = len(inputs)
    if min_sizes is None:
        min_ratio, max_ratio = min_ratio or 20, max_ratio or 90
        step = int(math.floor((max_ratio - min_ratio) /
                              max(n_maps - 2, 1)))
        min_sizes, max_sizes = [], []
        for r in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * r / 100.0)
            max_sizes.append(base_size * (r + step) / 100.0)
        min_sizes = [base_size * 0.10] + min_sizes[:n_maps - 1]
        max_sizes = [base_size * 0.20] + max_sizes[:n_maps - 1]
    locs, confs, priors, pvars = [], [], [], []
    img_h, img_w = _shape(image)[2], _shape(image)[3]
    for i, feat in enumerate(inputs):
        ar = aspect_ratios[i] if isinstance(aspect_ratios[i],
                                            (list, tuple)) \
            else [aspect_ratios[i]]
        mn = min_sizes[i]
        mn_list = [mn] if not isinstance(mn, (list, tuple)) else list(mn)
        mx = None
        if max_sizes is not None:
            mx = max_sizes[i]
            mx = [mx] if not isinstance(mx, (list, tuple)) else list(mx)
        fh, fw = _shape(feat)[2], _shape(feat)[3]
        step_i = None
        if steps is not None:
            step_i = steps[i] if isinstance(steps, (list, tuple)) else steps
        elif step_w is not None or step_h is not None:
            step_i = step_w if step_w is not None else step_h
        boxes = _prior(fh, fw, img_h, img_w, mn_list,
                       max_sizes=mx or (), aspect_ratios=ar, flip=flip,
                       clip=clip, offset=offset, step=step_i)
        per_cell = boxes.shape[2]
        boxes = boxes.reshape(-1, 4).to(feat.device)
        priors.append(boxes)
        pvars.append(torch.tensor(variance, dtype=torch.float32,
                                  device=feat.device)[None, :].repeat(
                                      boxes.shape[0], 1))
        loc = conv2d(feat, per_cell * 4, kernel_size, stride=stride,
                     padding=pad)
        conf = conv2d(feat, per_cell * num_classes, kernel_size,
                      stride=stride, padding=pad)

        def flat(t, last):
            return _op(lambda a: a.movedim(1, -1).reshape(
                a.shape[0], -1, last), t)

        locs.append(flat(loc, 4))
        confs.append(flat(conf, num_classes))
    return (concat(locs, axis=1), concat(confs, axis=1),
            concat(priors, axis=0), concat(pvars, axis=0))


def deform_conv2d(input, offset, mask, num_filters, filter_size,
                  stride=1, padding=0, dilation=1, groups=1,
                  deformable_groups=1, im2col_step=1, param_attr=None,
                  bias_attr=None, modulated=True, name=None):
    """``static.nn.deform_conv2d``: the filter parameter and the
    deformable convolution."""
    from ..vision.ops import deform_conv2d as _dcn
    cin = _shape(input)[1]
    ks = [filter_size] * 2 if isinstance(filter_size, int) \
        else list(filter_size)
    fan_in = (cin // groups) * int(np.prod(ks))
    bound = math.sqrt(1.0 / max(fan_in, 1))
    w = _make_param([num_filters, cin // groups] + ks, input.dtype,
                    param_attr, default_init=I.Uniform(-bound, bound))
    b = _make_param([num_filters], input.dtype, bias_attr, is_bias=True)
    return _dcn(input, offset, w, bias=b, stride=stride, padding=padding,
                dilation=dilation, deformable_groups=deformable_groups,
                groups=groups, mask=mask if modulated else None)

