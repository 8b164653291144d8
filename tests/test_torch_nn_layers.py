"""Every ported layer and functional of the layer API against the JAX
package's, forward and gradient, on the CPU.

One parametrised test: the same numpy inputs (made from a seed) go
through the JAX function on its tape and the port's; float inputs and
parameters get gradients from ``sum(out * cot)`` with a random
cotangent (``loss.backward()`` on both sides; the JAX tape runs staged
under one ``jax.jit`` a case).  Layers are built in both
packages and the JAX layer's weights are loaded into the port's through
``set_state_dict`` (the structured names must match).

Tolerances (f32 on both sides): forward within 3e-6 of the reference's
max |value| (FWD_TOL, about ten times the worst measured, 2.6e-7, gelu),
gradients within 1e-4 of each gradient's max |value| or of GRAD_FLOOR
(GRAD_TOL; worst measured 2.4e-5 of the floor: cross_entropy's weight
gradient, which cancels to about 1e-7).  The vision cases (convolutions,
pools, the norms, the sampling functionals and their layers) are held
to the same two tolerances; max-pool forwards (``EXACT``) must be equal.
A layer's parameters and buffers are copied into the port's layer as
they were before the JAX run (a batch norm in training updates its
running statistics as it runs).
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF

import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF

FWD_TOL = 3e-6
GRAD_TOL = 1e-4
# a gradient that cancels to near zero (max |g| below this) is held to
# GRAD_TOL * GRAD_FLOOR absolute
GRAD_FLOOR = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    """The port on the CPU.  The JAX reference compiles one program a
    case: these compiles skip XLA's optimization passes and the
    persistent cache (none is reused)."""
    tp.set_device("cpu")
    tp.seed(7)
    keys = ("jax_disable_most_optimizations", "jax_enable_compilation_cache")
    was = {k: jax.config.values[k] for k in keys}
    jax.config.update("jax_disable_most_optimizations", True)
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    for k, v in was.items():
        jax.config.update(k, v)


def f(*shape):
    """A float input of ``shape`` (differentiated)."""
    return ("f", shape)


def pos(*shape):
    """A float input in (0.05, 0.95) (probabilities)."""
    return ("p", shape)


def ints(high, *shape):
    """An int64 input in [0, high) (labels, ids; not differentiated)."""
    return ("i", shape, high)


def const(value):
    """A fixed array (masks, lengths, path tables; not differentiated)."""
    return ("c", value)


def _make(spec, rng):
    kind = spec[0]
    if kind == "f":
        return rng.randn(*spec[1]).astype(np.float32)
    if kind == "p":
        return rng.uniform(0.05, 0.95, spec[1]).astype(np.float32)
    if kind == "i":
        return rng.randint(0, spec[2], spec[1]).astype(np.int64)
    return np.asarray(spec[1])


def F_(fn):
    """A functional case: ``fn(F, *inputs)`` with F either package's
    nn.functional."""
    return ("fn", fn)


def L_(build, call=None):
    """A layer case: ``build(nn)`` in either package, called on the
    inputs (``call(layer, *inputs)`` when given)."""
    return ("layer", build, call)


PAD_IDX = 3
TABLE = np.array([[0, 1, -1], [0, 2, 3], [1, 4, -1], [0, 1, 5]], np.int64)
CODE = np.array([[1, 0, 0], [0, 1, 1], [1, 0, 0], [0, 0, 1]], np.int64)

# most cases share these shapes: the JAX tape compiles each primitive
# once per shape, so shared shapes keep the file fast
X = (4, 6)            # [N, C]
X3 = (2, 4, 6)
X4 = (2, 4, 4, 6)     # NCHW
MARGIN_T = np.array([1, -1, -1, 1], np.float32)
RUN_MEAN = np.linspace(-0.5, 0.5, 4).astype(np.float32)
RUN_VAR = np.linspace(0.5, 1.5, 4).astype(np.float32)
GRID = np.random.RandomState(5).uniform(-1.2, 1.2, (2, 3, 5, 2)).astype(
    np.float32)

CASES = {
    # ---- common functionals -------------------------------------------
    "linear": (F_(lambda F, x, w, b: F.linear(x, w, b)),
               [f(*X), f(6, 6), f(6)]),
    "linear-nobias": (F_(lambda F, x, w: F.linear(x, w)), [f(*X3), f(6, 6)]),
    "dropout-p0": (F_(lambda F, x: F.dropout(x, p=0.0)), [f(*X)]),
    "dropout-eval-downscale": (F_(lambda F, x: F.dropout(
        x, p=0.3, training=False, mode="downscale_in_infer")), [f(*X)]),
    "dropout2d-eval": (F_(lambda F, x: F.dropout2d(x, 0.4, training=False)),
                       [f(*X4)]),
    "dropout3d-eval": (F_(lambda F, x: F.dropout3d(x, 0.4, training=False)),
                       [f(1, *X4)]),
    "alpha_dropout-eval": (F_(lambda F, x: F.alpha_dropout(
        x, 0.4, training=False)), [f(*X)]),
    "embedding": (F_(lambda F, ids, w: F.embedding(ids, w)),
                  [ints(6, *X), f(6, 6)]),
    "embedding-padding": (F_(lambda F, ids, w: F.embedding(
        ids, w, padding_idx=PAD_IDX)), [ints(6, *X), f(6, 6)]),
    "one_hot": (F_(lambda F, x: F.one_hot(x, 6)), [ints(6, *X)]),
    "pad-constant-nchw": (F_(lambda F, x: F.pad(x, [1, 2, 0, 1], value=0.5)),
                          [f(*X4)]),
    "pad-constant-full": (F_(lambda F, x: F.pad(x, [0, 0, 1, 1, 2, 0])),
                          [f(*X3)]),
    "pad-reflect": (F_(lambda F, x: F.pad(x, [2, 1, 1, 2], mode="reflect")),
                    [f(*X4)]),
    "pad-replicate-nhwc": (F_(lambda F, x: F.pad(
        x, [1, 1, 2, 0], mode="replicate", data_format="NHWC")), [f(*X4)]),
    "pad-circular": (F_(lambda F, x: F.pad(x, [1, 2], mode="circular",
                                           data_format="NCL")), [f(*X3)]),
    "zeropad2d": (F_(lambda F, x: F.zeropad2d(x, [1, 0, 2, 1])), [f(*X4)]),
    "unfold": (F_(lambda F, x: F.unfold(x, [2, 3], strides=[1, 2],
                                        paddings=[1, 0, 0, 1])), [f(*X4)]),
    "fold": (F_(lambda F, x: F.fold(x, [4, 5], [2, 2])), [f(2, 16, 12)]),
    "interpolate-nearest-up": (F_(lambda F, x: F.interpolate(
        x, scale_factor=2, mode="nearest")), [f(*X4)]),
    "interpolate-nearest-down": (F_(lambda F, x: F.interpolate(
        x, size=[3, 2], mode="nearest")), [f(*X4)]),
    "interpolate-bilinear": (F_(lambda F, x: F.interpolate(
        x, size=[7, 9], mode="bilinear")), [f(*X4)]),
    "interpolate-bilinear-down": (F_(lambda F, x: F.interpolate(
        x, size=[3, 4], mode="bilinear")), [f(*X4)]),
    "interpolate-bilinear-corners": (F_(lambda F, x: F.interpolate(
        x, size=[7, 9], mode="bilinear", align_corners=True)), [f(*X4)]),
    "interpolate-bicubic": (F_(lambda F, x: F.interpolate(
        x, size=[6, 7], mode="bicubic")), [f(*X4)]),
    "interpolate-linear-nwc": (F_(lambda F, x: F.interpolate(
        x, size=[9], mode="linear", data_format="NWC")), [f(*X3)]),
    "interpolate-trilinear": (F_(lambda F, x: F.interpolate(
        x, scale_factor=[2, 1.5, 0.5], mode="trilinear")), [f(1, *X4)]),
    "interpolate-area": (F_(lambda F, x: F.interpolate(
        x, size=[3, 4], mode="area")), [f(*X4)]),
    "upsample": (F_(lambda F, x: F.upsample(x, scale_factor=2,
                                            mode="bilinear")), [f(*X4)]),
    "cosine_similarity": (F_(lambda F, a, b: F.cosine_similarity(a, b)),
                          [f(*X3), f(*X3)]),
    "pixel_shuffle": (F_(lambda F, x: F.pixel_shuffle(x, 2)), [f(*X4)]),
    "pixel_shuffle-nhwc": (F_(lambda F, x: F.pixel_shuffle(
        x, 2, data_format="NHWC")), [f(2, 4, 6, 4)]),
    "pixel_unshuffle": (F_(lambda F, x: F.pixel_unshuffle(x, 2)), [f(*X4)]),
    "channel_shuffle": (F_(lambda F, x: F.channel_shuffle(x, 2)), [f(*X4)]),
    "label_smooth": (F_(lambda F, x: F.label_smooth(x, epsilon=0.2)),
                     [pos(*X)]),
    "label_smooth-prior": (F_(lambda F, x, p: F.label_smooth(
        x, prior_dist=p, epsilon=0.1)), [pos(*X), pos(1, 6)]),
    "bilinear": (F_(lambda F, a, b, w, c: F.bilinear(a, b, w, c)),
                 [f(*X), f(*X), f(3, 6, 6), f(3)]),
    # ---- activations -------------------------------------------------
    **{f"act-{name}": (F_(lambda F, x, n=name, kw=kw: getattr(F, n)(x, **kw)),
                       [f(*X)])
       for name, kw in [
           ("relu", {}), ("relu6", {}), ("elu", {"alpha": 0.7}),
           ("selu", {}), ("celu", {"alpha": 1.3}), ("gelu", {}),
           ("sigmoid", {}), ("hardsigmoid", {}), ("hardswish", {}),
           ("hardtanh", {"min": -0.5, "max": 0.8}),
           ("hardshrink", {"threshold": 0.4}),
           ("softshrink", {"threshold": 0.3}), ("tanhshrink", {}),
           ("leaky_relu", {"negative_slope": 0.2}), ("log_sigmoid", {}),
           ("log_softmax", {"axis": 0}), ("softmax", {}),
           ("softplus", {"beta": 2.0, "threshold": 3.0}), ("softsign", {}),
           ("swish", {}), ("silu", {}), ("mish", {}), ("tanh", {}),
           ("thresholded_relu", {"threshold": 0.2}),
           ("maxout", {"groups": 2, "axis": 1}), ("glu", {}),
           ("rrelu", {"training": False})]},
    "act-prelu": (F_(lambda F, x, w: F.prelu(x, w)), [f(*X3), f(4)]),
    "act-prelu-scalar": (F_(lambda F, x, w: F.prelu(x, w)), [f(*X), f(1)]),
    "act-gelu-gpt": (F_(lambda F, x: F.gelu(x, approximate=True)), [f(*X)]),
    # ---- losses ------------------------------------------------------
    "cross_entropy": (F_(lambda F, x, y: F.cross_entropy(x, y)),
                      [f(*X), ints(6, 4)]),
    "cross_entropy-ignore-sum": (F_(lambda F, x, y: F.cross_entropy(
        x, y, ignore_index=1, reduction="sum")), [f(*X), ints(6, 4, 1)]),
    "cross_entropy-weight": (F_(lambda F, x, y, w: F.cross_entropy(
        x, y, weight=w)), [f(*X), ints(6, 4), pos(6)]),
    "cross_entropy-soft": (F_(lambda F, x, y: F.cross_entropy(
        x, y, soft_label=True)), [f(*X3), pos(*X3)]),
    "cross_entropy-smoothing": (F_(lambda F, x, y: F.cross_entropy(
        x, y, label_smoothing=0.1, reduction="none")), [f(*X), ints(6, 4)]),
    "cross_entropy-axis1": (F_(lambda F, x, y: F.cross_entropy(
        x, y, axis=1)), [f(*X3), ints(4, 2, 1, 6)]),
    "cross_entropy-probs": (F_(lambda F, x, y: F.cross_entropy(
        x, y, use_softmax=False)), [pos(*X), ints(6, 4)]),
    "softmax_with_cross_entropy": (F_(lambda F, x, y:
                                      F.softmax_with_cross_entropy(x, y)),
                                   [f(*X), ints(6, 4, 1)]),
    "binary_cross_entropy": (F_(lambda F, p, t, w: F.binary_cross_entropy(
        p, t, weight=w)), [pos(*X), pos(*X), pos(*X)]),
    "bce_with_logits": (F_(lambda F, z, t: F.binary_cross_entropy_with_logits(
        z, t, reduction="sum")), [f(*X), pos(*X)]),
    "bce_with_logits-weights": (F_(lambda F, z, t, w, pw:
                                   F.binary_cross_entropy_with_logits(
                                       z, t, weight=w, pos_weight=pw)),
                                [f(*X), pos(*X), pos(*X), pos(6)]),
    "mse_loss": (F_(lambda F, a, b: F.mse_loss(a, b)), [f(*X), f(*X)]),
    "square_error_cost": (F_(lambda F, a, b: F.square_error_cost(a, b)),
                          [f(*X), f(*X)]),
    "l1_loss": (F_(lambda F, a, b: F.l1_loss(a, b, reduction="none")),
                [f(*X), f(*X)]),
    "nll_loss": (F_(lambda F, x, y, w: F.nll_loss(x, y, weight=w,
                                                  ignore_index=2)),
                 [f(*X), ints(6, 4), pos(6)]),
    "kl_div-batchmean": (F_(lambda F, x, y: F.kl_div(x, y, "batchmean")),
                         [f(*X), pos(*X)]),
    "kl_div": (F_(lambda F, x, y: F.kl_div(x, y)), [f(*X), pos(*X)]),
    "smooth_l1_loss": (F_(lambda F, a, b: F.smooth_l1_loss(a, b, delta=0.7)),
                       [f(*X), f(*X)]),
    "margin_ranking_loss": (F_(lambda F, a, b, t: F.margin_ranking_loss(
        a, b, t, margin=0.2)), [f(4), f(4), const(MARGIN_T)]),
    "hinge_embedding_loss": (F_(lambda F, a, t: F.hinge_embedding_loss(
        a, t)), [f(4), const(MARGIN_T)]),
    "cosine_embedding_loss": (F_(lambda F, a, b, t: F.cosine_embedding_loss(
        a, b, t, margin=0.1)), [f(*X), f(*X), const(MARGIN_T.astype(
            np.int64))]),
    "log_loss": (F_(lambda F, p, t: F.log_loss(p, t)), [pos(4, 1), pos(4, 1)]),
    "sigmoid_focal_loss": (F_(lambda F, z, t: F.sigmoid_focal_loss(z, t)),
                           [f(*X), const((np.arange(24) % 2).reshape(
                               X).astype(np.float32))]),
    "sigmoid_focal_loss-norm": (F_(lambda F, z, t, n: F.sigmoid_focal_loss(
        z, t, normalizer=n, reduction="mean")),
        [f(*X), const(np.eye(*X, dtype=np.float32)),
         const(np.array([3.0], np.float32))]),
    "triplet_margin_loss": (F_(lambda F, a, p, n: F.triplet_margin_loss(
        a, p, n)), [f(*X), f(*X), f(*X)]),
    "triplet_margin_loss-swap": (F_(lambda F, a, p, n: F.triplet_margin_loss(
        a, p, n, p=1.0, swap=True, reduction="sum")), [f(*X), f(*X), f(*X)]),
    "dice_loss": (F_(lambda F, x, y: F.dice_loss(F.softmax(x), y)),
                  [f(*X), ints(6, 4, 1)]),
    "npair_loss": (F_(lambda F, a, p, y: F.npair_loss(a, p, y)),
                   [f(*X), f(*X), const(np.array([0, 1, 0, 2], np.int64))]),
    "hsigmoid_loss": (F_(lambda F, x, y, w, b: F.hsigmoid_loss(x, y, 6, w, b)),
                      [f(*X), ints(6, 4), f(5, 6), f(5, 1)]),
    "hsigmoid_loss-custom": (F_(lambda F, x, y, w, tb, cd: F.hsigmoid_loss(
        x, y, 6, w, path_table=tb, path_code=cd)),
        [f(*X), ints(6, 4), f(6, 6), const(TABLE), const(CODE)]),
    "layer_norm": (F_(lambda F, x, w, b: F.layer_norm(x, [4, 6], w, b,
                                                      epsilon=1e-6)),
                   [f(*X3), f(4, 6), f(4, 6)]),
    # ---- layers ------------------------------------------------------
    "Linear": (L_(lambda nn: nn.Linear(6, 6)), [f(*X)]),
    "Linear-nobias": (L_(lambda nn: nn.Linear(6, 6, bias_attr=False)),
                      [f(*X3)]),
    "Embedding": (L_(lambda nn: nn.Embedding(6, 6, padding_idx=PAD_IDX)),
                  [ints(6, *X)]),
    "Identity": (L_(lambda nn: nn.Identity()), [f(*X)]),
    "Flatten": (L_(lambda nn: nn.Flatten()), [f(*X4)]),
    "Pad1D": (L_(lambda nn: nn.Pad1D([1, 2], mode="reflect")), [f(*X3)]),
    "Pad2D": (L_(lambda nn: nn.Pad2D([1, 0, 2, 1], value=1.0)), [f(*X4)]),
    "Pad3D": (L_(lambda nn: nn.Pad3D([1, 1, 0, 1, 1, 0],
                                     mode="replicate")), [f(1, *X4)]),
    "ZeroPad2D": (L_(lambda nn: nn.ZeroPad2D([1, 1, 1, 1])), [f(*X4)]),
    "Upsample": (L_(lambda nn: nn.Upsample(size=[6, 7], mode="bicubic")),
                 [f(*X4)]),
    "UpsamplingBilinear2D": (L_(lambda nn: nn.UpsamplingBilinear2D(
        size=[7, 9])), [f(*X4)]),
    "UpsamplingNearest2D": (L_(lambda nn: nn.UpsamplingNearest2D(
        size=[3, 2])), [f(*X4)]),
    "CosineSimilarity": (L_(lambda nn: nn.CosineSimilarity(axis=1)),
                         [f(*X3), f(*X3)]),
    "Unfold": (L_(lambda nn: nn.Unfold([2, 3], strides=[1, 2],
                                       paddings=[1, 0, 0, 1])), [f(*X4)]),
    "Fold": (L_(lambda nn: nn.Fold([4, 5], [2, 2])), [f(2, 16, 12)]),
    "Bilinear": (L_(lambda nn: nn.Bilinear(6, 6, 3)), [f(*X), f(*X)]),
    "PixelShuffle": (L_(lambda nn: nn.PixelShuffle(2)), [f(*X4)]),
    "PixelUnshuffle": (L_(lambda nn: nn.PixelUnshuffle(2)), [f(*X4)]),
    "ChannelShuffle": (L_(lambda nn: nn.ChannelShuffle(2)), [f(*X4)]),
    "Dropout-eval": (L_(lambda nn: nn.Dropout(0.5).eval()), [f(*X)]),
    "Dropout2D-eval": (L_(lambda nn: nn.Dropout2D(0.5).eval()), [f(*X4)]),
    "Dropout3D-eval": (L_(lambda nn: nn.Dropout3D(0.5).eval()),
                       [f(1, *X4)]),
    "AlphaDropout-eval": (L_(lambda nn: nn.AlphaDropout(0.5).eval()),
                          [f(*X)]),
    "LayerNorm": (L_(lambda nn: nn.LayerNorm([4, 6], epsilon=1e-6)),
                  [f(*X3)]),
    **{f"layer-{name}": (L_(lambda nn, n=name, a=args: getattr(nn, n)(*a)),
                         [f(*X)])
       for name, args in [
           ("ReLU", ()), ("ReLU6", ()), ("ELU", (0.5,)), ("SELU", ()),
           ("CELU", (0.8,)), ("GELU", (True,)), ("Sigmoid", ()),
           ("Hardsigmoid", ()), ("Hardswish", ()), ("Hardtanh", ()),
           ("Hardshrink", ()), ("Softshrink", ()), ("Tanhshrink", ()),
           ("LeakyReLU", (0.1,)), ("LogSigmoid", ()), ("LogSoftmax", ()),
           ("Softmax", ()), ("Softplus", ()), ("Softsign", ()),
           ("Swish", ()), ("Silu", ()), ("Mish", ()), ("Tanh", ()),
           ("ThresholdedReLU", (0.3,)), ("Maxout", (2,)), ("GLU", ()),
           ("RReLU", ())]},
    "PReLU": (L_(lambda nn: nn.PReLU(4, init=0.1)), [f(*X3)]),
    "CrossEntropyLoss": (L_(lambda nn: nn.CrossEntropyLoss(
        soft_label=True)), [f(*X), pos(*X)]),
    "MSELoss": (L_(lambda nn: nn.MSELoss()), [f(*X), f(*X)]),
    "L1Loss": (L_(lambda nn: nn.L1Loss("sum")), [f(*X), f(*X)]),
    "NLLLoss": (L_(lambda nn: nn.NLLLoss()), [f(*X), ints(6, 4)]),
    "BCELoss": (L_(lambda nn: nn.BCELoss()), [pos(*X), pos(*X)]),
    "BCEWithLogitsLoss": (L_(lambda nn: nn.BCEWithLogitsLoss()),
                          [f(*X), pos(*X)]),
    "KLDivLoss": (L_(lambda nn: nn.KLDivLoss("sum")), [f(*X), pos(*X)]),
    "SmoothL1Loss": (L_(lambda nn: nn.SmoothL1Loss()), [f(*X), f(*X)]),
    "MarginRankingLoss": (L_(lambda nn: nn.MarginRankingLoss(0.1)),
                          [f(4), f(4), const(MARGIN_T)]),
    "HingeEmbeddingLoss": (L_(lambda nn: nn.HingeEmbeddingLoss()),
                           [f(4), const(MARGIN_T)]),
    "CosineEmbeddingLoss": (L_(lambda nn: nn.CosineEmbeddingLoss()),
                            [f(*X), f(*X), const(MARGIN_T.astype(np.int64))]),
    # F.ctc_loss through its layer, on unnormalized log-probabilities
    # (the recursion's gradient must be exact for any input)
    "CTCLoss": (L_(lambda nn: nn.CTCLoss(),
                   lambda l, lp, lab, il, ll: l(lp, lab, il, ll)),
                [f(4, 2, 6), const(np.array([[1, 2], [3, 3]], np.int64)),
                 const(np.array([4, 4], np.int64)),
                 const(np.array([1, 2], np.int64))]),
    "TripletMarginLoss": (L_(lambda nn: nn.TripletMarginLoss()),
                          [f(*X), f(*X), f(*X)]),
    "HSigmoidLoss": (L_(lambda nn: nn.HSigmoidLoss(6, 5)),
                     [f(*X), ints(5, 4)]),
    "Sequential": (L_(lambda nn: nn.Sequential(
        nn.Linear(6, 6), nn.ReLU(), nn.Linear(6, 6))), [f(*X)]),
    "Sequential-named": (L_(lambda nn: nn.Sequential(
        ("fc", nn.Linear(6, 6)), ("act", nn.Tanh()))), [f(*X)]),
    "LayerList": (L_(lambda nn: nn.LayerList(
        [nn.Linear(6, 6), nn.LayerNorm(6)]),
        lambda l, x: l[1](l[0](x))), [f(*X)]),
    "LayerDict": (L_(lambda nn: nn.LayerDict(
        {"a": nn.Linear(6, 6), "b": nn.Linear(6, 6)}),
        lambda l, x: l["a"](x) * l["b"](x)), [f(*X)]),
    # ---- convolutions ------------------------------------------------
    "conv2d": (F_(lambda F, x, w, b: F.conv2d(x, w, b, padding=1)),
               [f(*X4), f(6, 4, 3, 3), f(6)]),
    "conv2d-same-stride2": (F_(lambda F, x, w: F.conv2d(
        x, w, stride=2, padding="SAME")), [f(*X4), f(6, 4, 3, 3)]),
    "conv2d-pairs-dilation": (F_(lambda F, x, w: F.conv2d(
        x, w, padding=[1, 2, 0, 1], dilation=2)), [f(*X4), f(6, 4, 3, 3)]),
    "conv2d-groups-nhwc-valid": (F_(lambda F, x, w, b: F.conv2d(
        x, w, b, padding="VALID", groups=2, data_format="NHWC")),
        [f(2, 4, 6, 4), f(6, 2, 3, 3), f(6)]),
    "conv1d": (F_(lambda F, x, w, b: F.conv1d(x, w, b, stride=2,
                                              padding=[1])),
               [f(*X3), f(6, 4, 3), f(6)]),
    "conv3d": (F_(lambda F, x, w: F.conv3d(x, w, stride=[1, 2, 2],
                                           padding=1)),
               [f(1, *X4), f(3, 2, 3, 3, 3)]),
    "conv2d_transpose": (F_(lambda F, x, w, b: F.conv2d_transpose(
        x, w, b, stride=2, padding=1, output_padding=1)),
        [f(*X4), f(4, 3, 3, 3), f(3)]),
    "conv2d_transpose-groups-pairs": (F_(lambda F, x, w: F.conv2d_transpose(
        x, w, stride=2, padding=[0, 1, 1, 0], groups=2)),
        [f(*X4), f(4, 2, 3, 3)]),
    "conv2d_transpose-output_size": (F_(lambda F, x, w: F.conv2d_transpose(
        x, w, stride=2, padding=1, output_size=[6, 10])),
        [f(*X4), f(4, 3, 3, 3)]),
    "conv2d_transpose-same-dilation": (F_(lambda F, x, w: F.conv2d_transpose(
        x, w, stride=2, padding="SAME", dilation=2)),
        [f(*X4), f(4, 3, 3, 3)]),
    "conv1d_transpose": (F_(lambda F, x, w: F.conv1d_transpose(
        x, w, stride=2, padding=1, output_padding=1)), [f(*X3), f(4, 3, 3)]),
    "conv3d_transpose": (F_(lambda F, x, w: F.conv3d_transpose(
        x, w, stride=2)), [f(1, *X4), f(2, 2, 2, 2, 2)]),
    # ---- pools -------------------------------------------------------
    "max_pool2d": (F_(lambda F, x: F.max_pool2d(x, 3, 2, 1)), [f(*X4)]),
    "max_pool2d-ceil": (F_(lambda F, x: F.max_pool2d(x, 3, 2,
                                                     ceil_mode=True)),
                        [f(*X4)]),
    "max_pool2d-widepad": (F_(lambda F, x: F.max_pool2d(x, 3, 1, 2)),
                           [f(*X4)]),
    "max_pool2d-same": (F_(lambda F, x: F.max_pool2d(x, 3, 2, "SAME")),
                        [f(*X4)]),
    "max_pool2d-nhwc-mask": (F_(lambda F, x: F.max_pool2d(
        x, 2, return_mask=True, data_format="NHWC")), [f(2, 4, 6, 4)]),
    "max_pool1d-ceil": (F_(lambda F, x: F.max_pool1d(x, 4, 4,
                                                     ceil_mode=True)),
                        [f(*X3)]),
    "avg_pool2d-exclusive": (F_(lambda F, x: F.avg_pool2d(x, 3, 2, 1)),
                             [f(*X4)]),
    "avg_pool2d-inclusive-ceil": (F_(lambda F, x: F.avg_pool2d(
        x, 3, 2, 1, ceil_mode=True, exclusive=False)), [f(*X4)]),
    "avg_pool2d-exclusive-ceil": (F_(lambda F, x: F.avg_pool2d(
        x, 3, 2, [0, 1, 1, 0], ceil_mode=True)), [f(*X4)]),
    "avg_pool2d-divisor": (F_(lambda F, x: F.avg_pool2d(
        x, 2, divisor_override=3)), [f(*X4)]),
    "avg_pool2d-same-exclusive": (F_(lambda F, x: F.avg_pool2d(
        x, 3, 2, "SAME")), [f(*X4)]),
    "avg_pool1d": (F_(lambda F, x: F.avg_pool1d(x, 3, 2, 1)), [f(*X3)]),
    "avg_pool3d-nhwc": (F_(lambda F, x: F.avg_pool3d(
        x, 2, 1, [0, 1, 1], data_format="NDHWC")), [f(1, 2, 4, 6, 4)]),
    "adaptive_avg_pool2d": (F_(lambda F, x: F.adaptive_avg_pool2d(
        x, [3, 4])), [f(*X4)]),
    "adaptive_avg_pool2d-nhwc": (F_(lambda F, x: F.adaptive_avg_pool2d(
        x, [3, None], data_format="NHWC")), [f(2, 4, 6, 4)]),
    "adaptive_max_pool2d": (F_(lambda F, x: F.adaptive_max_pool2d(
        x, [3, 4])), [f(*X4)]),
    "batch_norm-train": (F_(lambda F, x, m, v, w, b: F.batch_norm(
        x, m, v, w, b, training=True)),
        [f(*X4), const(RUN_MEAN), const(RUN_VAR), f(4), f(4)]),
    "batch_norm-eval": (F_(lambda F, x, m, v, w, b: F.batch_norm(
        x, m, v, w, b, epsilon=1e-3)),
        [f(*X4), const(RUN_MEAN), const(RUN_VAR), f(4), f(4)]),
    "batch_norm-global-stats": (F_(lambda F, x, m, v: F.batch_norm(
        x, m, v, training=True, use_global_stats=True)),
        [f(*X4), const(RUN_MEAN), const(RUN_VAR)]),
    "batch_norm-nhwc-train": (F_(lambda F, x, m, v, w: F.batch_norm(
        x, m, v, w, training=True, data_format="NHWC")),
        [f(2, 4, 6, 4), const(RUN_MEAN), const(RUN_VAR), f(4)]),
    "batch_norm-nc-train": (F_(lambda F, x, m, v: F.batch_norm(
        x, m, v, training=True, momentum=0.7)),
        [f(*X), const(np.zeros(6, np.float32)),
         const(np.ones(6, np.float32))]),
    "instance_norm": (F_(lambda F, x, w, b: F.instance_norm(
        x, weight=w, bias=b)), [f(*X4), f(4), f(4)]),
    "instance_norm-nhwc": (F_(lambda F, x: F.instance_norm(
        x, data_format="NHWC")), [f(2, 4, 6, 4)]),
    "group_norm": (F_(lambda F, x, w, b: F.group_norm(x, 2, 1e-4, w, b)),
                   [f(*X4), f(4), f(4)]),
    "group_norm-nhwc": (F_(lambda F, x: F.group_norm(
        x, 2, data_format="NHWC")), [f(2, 4, 6, 4)]),
    "normalize": (F_(lambda F, x: F.normalize(x)), [f(*X3)]),
    "local_response_norm-even": (F_(lambda F, x: F.local_response_norm(
        x, 2, alpha=0.5, k=2.0)), [f(*X4)]),
    "local_response_norm-nhwc": (F_(lambda F, x: F.local_response_norm(
        x, 3, alpha=0.5, beta=0.5, data_format="NHWC")), [f(2, 4, 6, 4)]),
    # ---- sampling ----------------------------------------------------
    "grid_sample": (F_(lambda F, x, g: F.grid_sample(x, g)),
                    [f(*X4), f(2, 3, 5, 2)]),
    # nearest sampling has no gradient in the grid: it is a constant here
    "grid_sample-nearest-border": (F_(lambda F, x, g: F.grid_sample(
        x, g, mode="nearest", padding_mode="border", align_corners=False)),
        [f(*X4), const(GRID)]),
    "affine_grid": (F_(lambda F, t: F.affine_grid(t, [2, 4, 4, 6])),
                    [f(2, 2, 3)]),
    "affine_grid-corners-off": (F_(lambda F, t: F.affine_grid(
        t, [2, 4, 4, 6], align_corners=False)), [f(2, 2, 3)]),
    "temporal_shift": (F_(lambda F, x: F.temporal_shift(x, 2)), [f(*X4)]),
    # ---- vision layers -----------------------------------------------
    "Conv2D": (L_(lambda nn: nn.Conv2D(4, 6, 3, padding=1)), [f(*X4)]),
    "Conv2D-groups-stride": (L_(lambda nn: nn.Conv2D(
        4, 6, 3, stride=2, groups=2, dilation=1, padding="SAME",
        padding_mode="reflect", bias_attr=False)), [f(*X4)]),
    "Conv1D": (L_(lambda nn: nn.Conv1D(4, 6, 3, padding=1)), [f(*X3)]),
    "Conv3D": (L_(lambda nn: nn.Conv3D(2, 3, 2)), [f(1, *X4)]),
    "Conv2DTranspose": (L_(lambda nn: nn.Conv2DTranspose(
        4, 3, 3, stride=2, padding=1, output_padding=1)), [f(*X4)]),
    "Conv2DTranspose-output_size": (L_(lambda nn: nn.Conv2DTranspose(
        4, 4, 3, stride=2, groups=2), lambda l, x: l(x, output_size=[8, 12])),
        [f(*X4)]),
    "Conv1DTranspose": (L_(lambda nn: nn.Conv1DTranspose(4, 3, 3, stride=2)),
                        [f(*X3)]),
    "Conv3DTranspose": (L_(lambda nn: nn.Conv3DTranspose(2, 2, 2, stride=2)),
                        [f(1, *X4)]),
    "MaxPool2D": (L_(lambda nn: nn.MaxPool2D(3, 2, 1)), [f(*X4)]),
    "MaxPool1D": (L_(lambda nn: nn.MaxPool1D(2)), [f(*X3)]),
    "MaxPool3D": (L_(lambda nn: nn.MaxPool3D(2, 2, ceil_mode=True)),
                  [f(1, *X4)]),
    "AvgPool2D": (L_(lambda nn: nn.AvgPool2D(3, 2, 1, exclusive=False)),
                  [f(*X4)]),
    "AvgPool1D": (L_(lambda nn: nn.AvgPool1D(3, 2, 1)), [f(*X3)]),
    "AvgPool3D": (L_(lambda nn: nn.AvgPool3D(2, divisor_override=5)),
                  [f(1, *X4)]),
    "AdaptiveAvgPool2D": (L_(lambda nn: nn.AdaptiveAvgPool2D((1, 1))),
                          [f(*X4)]),
    "AdaptiveMaxPool2D": (L_(lambda nn: nn.AdaptiveMaxPool2D(3)), [f(*X4)]),
    "AdaptiveAvgPool1D": (L_(lambda nn: nn.AdaptiveAvgPool1D(4)), [f(*X3)]),
    "AdaptiveMaxPool1D": (L_(lambda nn: nn.AdaptiveMaxPool1D(4)), [f(*X3)]),
    "AdaptiveAvgPool3D": (L_(lambda nn: nn.AdaptiveAvgPool3D(2)),
                          [f(1, *X4)]),
    "AdaptiveMaxPool3D": (L_(lambda nn: nn.AdaptiveMaxPool3D([1, 3, 4])),
                          [f(1, *X4)]),
    "BatchNorm2D-train": (L_(lambda nn: nn.BatchNorm2D(4)), [f(*X4)]),
    "BatchNorm2D-eval": (L_(lambda nn: nn.BatchNorm2D(4).eval()), [f(*X4)]),
    "BatchNorm1D": (L_(lambda nn: nn.BatchNorm1D(6)), [f(*X)]),
    "BatchNorm3D": (L_(lambda nn: nn.BatchNorm3D(2)), [f(1, *X4)]),
    "BatchNorm-act": (L_(lambda nn: nn.BatchNorm(4, act="relu")), [f(*X4)]),
    "SyncBatchNorm": (L_(lambda nn: nn.SyncBatchNorm.convert_sync_batchnorm(
        nn.Sequential(nn.Conv2D(4, 4, 1, bias_attr=False),
                      nn.BatchNorm2D(4)))), [f(*X4)]),
    "GroupNorm": (L_(lambda nn: nn.GroupNorm(2, 4)), [f(*X4)]),
    "InstanceNorm1D": (L_(lambda nn: nn.InstanceNorm1D(4)), [f(*X3)]),
    "InstanceNorm2D": (L_(lambda nn: nn.InstanceNorm2D(4)), [f(*X4)]),
    "InstanceNorm3D-noaffine": (L_(lambda nn: nn.InstanceNorm3D(
        2, weight_attr=False)), [f(1, *X4)]),
    "LocalResponseNorm": (L_(lambda nn: nn.LocalResponseNorm(4, alpha=0.3)),
                          [f(*X4)]),
    "SpectralNorm": (L_(lambda nn: nn.SpectralNorm([4, 6], dim=1,
                                                    power_iters=2)),
                     [f(4, 6)]),
    "RMSNorm": (L_(lambda nn: nn.RMSNorm(6)), [f(*X3)]),
    "PairwiseDistance": (L_(lambda nn: nn.PairwiseDistance()),
                         [f(*X), f(*X)]),
    "PairwiseDistance-inf": (L_(lambda nn: nn.PairwiseDistance(
        p=float("inf"), keepdim=True)), [f(*X), f(*X)]),
}

# max-pool forwards select inputs: the port's must equal the reference's
EXACT = {n for n in CASES if n.startswith(("max_pool", "MaxPool",
                                           "adaptive_max", "AdaptiveMax"))}


def _jax_run(case, arrays, rng):
    """The JAX forward, a cotangent of its output's shape from ``rng``,
    and the gradients of ``sum(out * cot)`` by ``backward()`` on the JAX
    tape.  The tape runs under one ``jax.jit``, so each case compiles
    one program instead of every op it runs one by one."""
    kind = case[0]
    layer = case[1](jnn) if kind == "layer" else None
    state = {} if layer is None else \
        {n: np.asarray(v.data) for n, v in layer.state_dict().items()}

    def forward(st, *arrs):
        if layer is not None:
            # each trace starts from the built state, an argument of the
            # program (a batch norm in training, a spectral norm write
            # theirs as they run)
            layer.set_state_dict({n: jp.Tensor(v) for n, v in st.items()})
        xs = [jp.Tensor(a, stop_gradient=not grad)
              for a, (_, grad) in zip(arrs, arrays)]
        if kind == "fn":
            out = case[1](JF, *xs)
        else:
            out = case[2](layer, *xs) if case[2] else layer(*xs)
        return xs, out[0] if isinstance(out, tuple) else out

    raw = [a for a, _ in arrays]
    shape = jax.eval_shape(lambda *a: forward(*a)[1].data, state, *raw).shape
    cot = np.asarray(rng.randn(*shape), np.float32)

    def forward_backward(st, *arrs):
        xs, out = forward(st, *arrs)
        grads = {}
        if not out.stop_gradient:
            (out * jp.Tensor(cot)).sum().backward()
            grads = {f"in{i}": x.grad.data for i, x in enumerate(xs)
                     if x.grad is not None}
            if layer is not None:
                grads.update({n: p.grad.data
                              for n, p in layer.named_parameters()
                              if p.grad is not None})
        return out.data, grads

    fwd, grads = jax.jit(forward_backward)(state, *raw)
    if layer is not None:
        layer.clear_gradients()     # they held the trace's values
    return (np.asarray(fwd), cot,
            {k: np.asarray(v) for k, v in grads.items()}, layer, state)


def _port_run(case, arrays, cot, jlayer, state):
    kind = case[0]
    xs = [torch.from_numpy(a.copy()).requires_grad_(grad)
          for a, grad in arrays]
    layer = None
    if kind == "fn":
        out = case[1](TF, *xs)
    else:
        layer = case[1](tnn)
        layer.train(jlayer.training)
        layer.set_state_dict(state)
        out = case[2](layer, *xs) if case[2] else layer(*xs)
    if isinstance(out, tuple):
        out = out[0]
    fwd = out.detach().numpy()
    grads = {}
    if out.requires_grad:
        (out * torch.from_numpy(cot)).sum().backward()
        grads = {f"in{i}": x.grad.numpy() for i, x in enumerate(xs)
                 if x.grad is not None}
        if layer is not None:
            grads.update({n: p.grad.numpy()
                          for n, p in layer.named_parameters()
                          if p.grad is not None})
    return fwd, grads


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_and_functional_match_jax(name):
    case, specs = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    arrays = [(_make(s, rng), s[0] in ("f", "p")) for s in specs]
    jfwd, cot, jgrads, jlayer, state = _jax_run(case, arrays, rng)
    tfwd, tgrads = _port_run(case, arrays, cot, jlayer, state)
    assert tfwd.shape == jfwd.shape, (tfwd.shape, jfwd.shape)
    scale = max(float(np.abs(jfwd).max()), 1e-30) if jfwd.size else 1.0
    err = float(np.abs(tfwd.astype(np.float64) - jfwd).max()) \
        if jfwd.size else 0.0
    assert err <= FWD_TOL * scale, f"forward: {err} vs {scale}"
    if name in EXACT:
        assert err == 0.0, f"max-pool forward differs by {err}"
    assert set(tgrads) == set(jgrads), (sorted(tgrads), sorted(jgrads))
    for key, jg in jgrads.items():
        gscale = max(float(np.abs(jg).max()), GRAD_FLOOR)
        gerr = float(np.abs(tgrads[key] - jg).max())
        assert gerr <= GRAD_TOL * gscale, f"grad {key}: {gerr} vs {gscale}"
