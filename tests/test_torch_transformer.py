"""The port's transformer layers and ``auto_cast`` against the JAX
package's, on the CPU, at small size (d_model 32, 4 heads of 8, S <= 16;
one case at S = 128, D = 64 with the JAX Pallas kernels in interpret
mode as the reference).

``MultiHeadAttention`` without a mask, with an additive and a boolean
mask, with an incremental ``Cache`` and a ``StaticCache`` over 3 steps;
pre- and post-norm encoder and decoder layers; the whole
``nn.Transformer`` at dropout 0 with the causal target mask: forward
and every gradient (``sum(out * cot)`` backward on the JAX tape).
Under ``auto_cast(dtype='bfloat16')`` the port casts the same ops as
the JAX package (each sublayer's output dtype and each functional's)
and agrees within the bf16 tolerance.

Tolerances: f32 forward within 6e-6 of the reference's max |value|
(FWD_TOL), gradients within 1e-4 of each one's max |value| (GRAD_TOL),
bf16 within 2e-2 of the scale (BF16_TOL).  Worst measured, the
interpret-mode case included: forward 6.9e-7, gradients 7.1e-6, bf16
3.3e-3 (the port's plain attention rounds once to bf16 where the JAX
composite also rounds its probabilities).  The JAX side of each parity
case runs its tape (``backward()`` included) under one ``jax.jit``.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import importlib

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.amp import auto_cast as jauto_cast

import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.amp import auto_cast as tauto_cast
from paddle_tpu_torch.core.dtype import dtype_name
from paddle_tpu_torch.nn.functional import attention as tattn

FWD_TOL = 6e-6
GRAD_TOL = 1e-4
# a gradient that is zero up to rounding (the key projection's bias: a
# softmax does not see a constant added to a row of scores) is held to
# GRAD_TOL * GRAD_FLOOR of the largest gradient of the call
GRAD_FLOOR = 1e-2
BF16_TOL = 2e-2
D_MODEL, HEADS, B, S = 32, 4, 2, 8


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    """The port on the CPU.  The JAX reference compiles a program a case
    (or, eagerly, an op): these compiles skip XLA's optimization passes
    and the persistent cache (none is reused)."""
    tp.set_device("cpu")
    tp.seed(13)
    keys = ("jax_disable_most_optimizations", "jax_enable_compilation_cache")
    was = {k: jax.config.values[k] for k in keys}
    jax.config.update("jax_disable_most_optimizations", True)
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    for k, v in was.items():
        jax.config.update(k, v)


def _np(t):
    if torch.is_tensor(t):
        return t.detach().float().numpy()
    return np.asarray(t.data if isinstance(t, jp.Tensor) else t,
                      np.float32)


def _sync(jlayer, tlayer):
    tlayer.set_state_dict({k: _np(v) for k, v in
                           jlayer.state_dict().items()})


def _close(got, want, tol, what, floor=1e-30):
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} vs scale {scale}"


def _jax_run(jlayer, arrays, call, rng):
    """The JAX forward ``call(layer, *xs)``, a cotangent of its output's
    shape from ``rng`` and the gradients of ``sum(out * cot)`` by
    ``backward()`` on the JAX tape, staged under one ``jax.jit`` (one
    compile a case instead of one an op)."""
    def forward(*arrs):
        xs = [jp.Tensor(a, stop_gradient=False) for a in arrs]
        return xs, call(jlayer, *xs)

    shape = jax.eval_shape(lambda *a: forward(*a)[1].data, *arrays).shape
    cot = rng.randn(*shape).astype(np.float32)

    def forward_backward(*arrs):
        xs, out = forward(*arrs)
        (out * jp.Tensor(cot)).sum().backward()
        grads = {f"input {i}": x.grad.data for i, x in enumerate(xs)}
        grads.update({n: p.grad.data for n, p in jlayer.named_parameters()
                      if p.grad is not None})
        return out.data, grads

    fwd, grads = jax.jit(forward_backward)(*arrays)
    jlayer.clear_gradients()        # they held the trace's values
    return (np.asarray(fwd, np.float32), cot,
            {k: np.asarray(v, np.float32) for k, v in grads.items()})


def _run_both(jlayer, tlayer, arrays, call, rng):
    """Both layers on the same inputs (``call(layer, *xs)``): the
    forward and every gradient of ``sum(out * cot)``."""
    jfwd, cot, want = _jax_run(jlayer, arrays, call, rng)
    tx = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    tout = call(tlayer, *tx)
    _close(_np(tout), jfwd, FWD_TOL, "forward")
    (tout * torch.from_numpy(cot)).sum().backward()
    got = {f"input {i}": b.grad.numpy() for i, b in enumerate(tx)}
    got.update({n: p.grad.numpy() for n, p in tlayer.named_parameters()
                if p.grad is not None})
    assert set(got) == set(want)
    floor = GRAD_FLOOR * max(float(np.abs(g).max()) for g in want.values())
    for n, g in want.items():
        _close(got[n], g, GRAD_TOL, n, floor)


def _x(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _causal(s):
    return np.where(np.tril(np.ones((s, s), bool)), 0.0,
                    -np.inf).astype(np.float32)


@pytest.mark.parametrize("mask", [None, "additive", "bool"])
def test_multi_head_attention_matches_jax(mask):
    rng = np.random.RandomState(1)
    j = jnn.MultiHeadAttention(D_MODEL, HEADS)
    t = tnn.MultiHeadAttention(D_MODEL, HEADS)
    _sync(j, t)
    q, kv = _x(rng, B, S, D_MODEL), _x(rng, B, S, D_MODEL)
    if mask is None:
        m = None
    elif mask == "additive":
        m = _causal(S)
    else:
        m = rng.rand(B, 1, S, S) > 0.3
        m[..., 0] = True

    def call(layer, a, b):
        mk = None if m is None else (
            jp.to_tensor(m) if layer is j else torch.from_numpy(m))
        return layer(a, b, b, attn_mask=mk)

    _run_both(j, t, [q, kv], call, rng)


@pytest.mark.parametrize("kind", ["Cache", "StaticCache"])
def test_multi_head_attention_caches_over_three_steps(kind):
    """Incremental decoding: each step feeds one query token and the
    cache the previous step returned (``Cache`` grows, ``StaticCache``
    holds the projected memory)."""
    rng = np.random.RandomState(2)
    j = jnn.MultiHeadAttention(D_MODEL, HEADS)
    t = tnn.MultiHeadAttention(D_MODEL, HEADS)
    _sync(j, t)
    mem = _x(rng, B, S, D_MODEL)
    jmem, tmem = jp.to_tensor(mem), torch.from_numpy(mem)
    if kind == "Cache":
        jc, tc = j.gen_cache(jmem), t.gen_cache(tmem)
    else:
        jc = j.gen_cache(jmem, jmem, jnn.MultiHeadAttention.StaticCache)
        tc = t.gen_cache(tmem, tmem, tnn.MultiHeadAttention.StaticCache)
    assert type(tc).__name__ == kind
    for step in range(3):
        x = _x(rng, B, 1, D_MODEL)
        jout, jc = j(jp.to_tensor(x), cache=jc)
        tout, tc = t(torch.from_numpy(x), cache=tc)
        _close(_np(tout), _np(jout), FWD_TOL, f"step {step}")
        _close(_np(tc.k), _np(jc.k), FWD_TOL, f"cache k {step}")
        assert tuple(tc.k.shape) == tuple(np.asarray(jc.k.data).shape)
    assert tc.k.shape[1] == (3 if kind == "Cache" else S)


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("which", ["encoder", "decoder"])
def test_encoder_decoder_layers_match_jax(which, normalize_before):
    rng = np.random.RandomState(3)
    kw = dict(dropout=0.0, normalize_before=normalize_before,
              activation="gelu" if normalize_before else "relu")
    if which == "encoder":
        j = jnn.TransformerEncoderLayer(D_MODEL, HEADS, 64, **kw)
        t = tnn.TransformerEncoderLayer(D_MODEL, HEADS, 64, **kw)
        _sync(j, t)
        _run_both(j, t, [_x(rng, B, S, D_MODEL)],
                  lambda layer, x: layer(x), rng)
        return
    j = jnn.TransformerDecoderLayer(D_MODEL, HEADS, 64, **kw)
    t = tnn.TransformerDecoderLayer(D_MODEL, HEADS, 64, **kw)
    _sync(j, t)
    mask = _causal(S)

    def call(layer, x, mem):
        m = jp.to_tensor(mask) if layer is j else torch.from_numpy(mask)
        return layer(x, mem, tgt_mask=m)

    _run_both(j, t, [_x(rng, B, S, D_MODEL), _x(rng, B, S, D_MODEL)],
              call, rng)


def test_transformer_matches_jax():
    """2 + 2 layers, d_model 32, 4 heads, dropout 0, post-norm, the
    square subsequent mask on the decoder's self-attention."""
    rng = np.random.RandomState(4)
    j = jnn.Transformer(D_MODEL, HEADS, 2, 2, 64, dropout=0.0)
    t = tnn.Transformer(D_MODEL, HEADS, 2, 2, 64, dropout=0.0)
    _sync(j, t)
    jm = j.generate_square_subsequent_mask(S)
    tm = t.generate_square_subsequent_mask(S)
    assert np.array_equal(_np(tm), _np(jm))

    def call(layer, src, tgt):
        return layer(src, tgt, tgt_mask=jm if layer is j else tm)

    _run_both(j, t, [_x(rng, B, S, D_MODEL), _x(rng, B, S, D_MODEL)],
              call, rng)


def test_attention_against_jax_kernel_route():
    """S = 128, D = 64: the JAX ``MultiHeadAttention`` reaches its
    Pallas kernels (interpret mode), the port's its CPU plain version
    of rows 1-3."""
    fa = importlib.import_module("paddle_tpu.ops.flash_attention")
    rng = np.random.RandomState(5)
    j = jnn.MultiHeadAttention(128, 2)
    t = tnn.MultiHeadAttention(128, 2)
    _sync(j, t)
    x = (_x(rng, 1, 128, 128) * 0.5)
    fa.set_interpret_mode(True)
    try:
        _run_both(j, t, [x], lambda layer, a: layer(a), rng)
    finally:
        fa.set_interpret_mode(False)


def _dtypes_by_layer(layer, run, dtype_of):
    got = {}
    handles = []
    for name, sub in layer.named_sublayers():
        def hook(l, ins, out, name=name):
            o = out[0] if isinstance(out, tuple) else out
            got[name] = dtype_of(o)
        handles.append(sub.register_forward_post_hook(hook))
    out = run()
    for h in handles:
        h.remove()
    got[""] = dtype_of(out)
    return got, out


def test_auto_cast_casts_the_ops_jax_casts():
    """A small Transformer under auto_cast(dtype='bfloat16'): every
    sublayer's output dtype equal to the JAX package's, the output
    within the bf16 tolerance."""
    rng = np.random.RandomState(6)
    j = jnn.Transformer(D_MODEL, HEADS, 1, 1, 64, dropout=0.0)
    t = tnn.Transformer(D_MODEL, HEADS, 1, 1, 64, dropout=0.0)
    _sync(j, t)
    src, tgt = _x(rng, B, S, D_MODEL), _x(rng, B, S, D_MODEL)
    mask = _causal(S)
    jd = {}

    def jax_forward(a, b, m):
        # staged under jax.jit: the hooks record dtypes while tracing
        got, out = _dtypes_by_layer(
            j, lambda: j(jp.Tensor(a), jp.Tensor(b),
                         tgt_mask=jp.Tensor(m)).data,
            lambda o: str(o.dtype))
        jd.update(got)
        return out

    with jauto_cast(dtype="bfloat16"):
        jout = jax.jit(jax_forward)(src, tgt, mask)
    with tauto_cast(dtype="bfloat16"):
        td, tout = _dtypes_by_layer(
            t, lambda: t(torch.from_numpy(src), torch.from_numpy(tgt),
                         tgt_mask=torch.from_numpy(mask)),
            lambda o: dtype_name(o.dtype))
    assert td == jd
    assert "bfloat16" in td.values() and "float32" in td.values()
    _close(_np(tout), _np(jout), BF16_TOL, "bf16 output")


OPS = {
    "linear": lambda F, x, w: F.linear(x, w),
    "softmax": lambda F, x, w: F.softmax(x),
    "layer_norm": lambda F, x, w: F.layer_norm(x, 6),
    "relu": lambda F, x, w: F.relu(x),
    "gelu": lambda F, x, w: F.gelu(x),
    "cross_entropy": lambda F, x, w: F.cross_entropy(
        x, x.argmax(-1) if hasattr(x, "argmax") else None),
    "mse_loss": lambda F, x, w: F.mse_loss(x, x),
    "log_softmax": lambda F, x, w: F.log_softmax(x),
    "dropout": lambda F, x, w: F.dropout(x, 0.0),
    "embedding": lambda F, x, w: F.embedding(
        x.argmax(-1) if hasattr(x, "argmax") else None, w),
    "sdpa": lambda F, x, w: F.scaled_dot_product_attention(
        x.reshape([1, 4, 1, 6]), x.reshape([1, 4, 1, 6]),
        x.reshape([1, 4, 1, 6])),
}


@pytest.mark.parametrize("in_dtype,level", [("float32", "O1"),
                                            ("bfloat16", "O1"),
                                            ("float32", "O2")])
def test_auto_cast_op_dtypes_match_jax(in_dtype, level):
    rng = np.random.RandomState(7)
    x, w = _x(rng, 4, 6), _x(rng, 6, 6)
    jx = jp.to_tensor(x).astype(in_dtype)
    jw = jp.to_tensor(w)
    tx = torch.from_numpy(x).to(getattr(torch, in_dtype))
    tw = torch.from_numpy(w)
    for name, op in OPS.items():
        with jauto_cast(dtype="bfloat16", level=level):
            # dtypes only: traced, not compiled
            jd = str(jax.eval_shape(
                lambda a, b: op(JF, jp.Tensor(a), jp.Tensor(b)).data,
                jx.data, jw.data).dtype)
        with tauto_cast(dtype="bfloat16", level=level):
            td = dtype_name(op(TF, tx, tw).dtype)
        assert td == jd, f"{name}: {td} vs {jd}"


def test_flash_attention_route():
    """The route is a function of shapes, dtype and device; on the CPU
    the composite runs only off the kernels' shapes and is not counted
    (the counter counts CUDA calls)."""
    def qkv(s, d, sk=None, dtype=torch.float32, hkv=2):
        return (torch.randn(1, s, 4, d, dtype=dtype),
                torch.randn(1, sk or s, hkv, d, dtype=dtype),
                torch.randn(1, sk or s, hkv, d, dtype=dtype))

    assert tattn.kernel_route(*qkv(8, 8))
    assert tattn.kernel_route(*qkv(200, 64))
    assert not tattn.kernel_route(*qkv(8, 64, sk=12))
    assert not tattn.kernel_route(*qkv(8, 64), return_softmax=True)
    before = tattn.COMPOSITE.launches
    q, k, v = qkv(8, 8, sk=12)
    out = TF.flash_attention(q, k, v)
    ref = torch.softmax(torch.einsum(
        "bqhd,bkhd->bhqk", q, k.repeat_interleave(2, 2)) / 8 ** 0.5, -1)
    ref = torch.einsum("bhqk,bkhd->bqhd", ref, v.repeat_interleave(2, 2))
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    out2, none = TF.flash_attention(*qkv(8, 64), return_softmax=True)
    assert none is None and out2.shape == (1, 8, 4, 64)
    assert tattn.COMPOSITE.launches == before
