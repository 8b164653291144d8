"""The port's fp8 (e4m3) ops against the JAX package's, on the CPU.

Codes: ``quantize_channel`` / ``quantize_kv`` with ``dtype='fp8'`` give
the JAX codes bit for bit (compared through ``uint8`` views: torch has no
``torch.equal`` for ``float8_e4m3fn``) and the same f32 scales, across
shapes, axes and input dtypes; the mode names resolve as JAX's.
Matmul: ``quantized_matmul(dtype='fp8')`` against the JAX composite
``_qmm_composite`` (its fp8 branch, an f32 dot over the codes) within
1e-5 of max |y|: every product of two e4m3 values is exact in f32, the
sums are f32 in two libraries' orders.  ``fake_quant_matmul`` fp8
gradients within 1e-6 of their largest value (f32 products in another
order).  Attention: the plain versions of the four entry points over
e4m3 caches against JAX's composites (``_decode_composite``,
``_paged_composite``, ``_window_composite``, ``_paged_window_composite``,
which the JAX package runs for fp8) in f32, 2e-5 as for int8; no slot
of length 0 (the composite averages uniformly over an empty slot where
the kernels give zeros).  The CUDA wrappers' checks, reachable on the
CPU, refuse mixed or wrong code dtypes before any launch.  The error
ratio that sets chip_smoke's ``TOL_TEACHER_FP8``: the JAX model's own
teacher-forced error over an fp8 cache against its error over an int8
cache.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import importlib
import math
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT

jda = importlib.import_module("paddle_tpu.ops.decode_attention")
jqm = importlib.import_module("paddle_tpu.ops.quantized_matmul")
tda = importlib.import_module("paddle_tpu_torch.ops.decode_attention")
tqm = importlib.import_module("paddle_tpu_torch.ops.quantized_matmul")

TOL = dict(rtol=2e-5, atol=2e-5)
E4M3 = torch.float8_e4m3fn


def t(a):
    """numpy (e4m3 through its bytes) -> torch."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(E4M3)
    return torch.from_numpy(a.copy())


def codes(a):
    """The bytes of e4m3 codes, torch or numpy."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


# ---- codes and mode names ---------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,axis", [((7, 96), 1), ((96, 40), 0),
                                        ((3, 5, 64), -1), ((2, 4, 9, 128), 2)])
def test_fp8_codes_bitwise_equal_to_jax(shape, axis, dtype):
    rng = np.random.RandomState(len(shape) + axis)
    x = (rng.randn(*shape) * 3).astype(np.float32)
    # exact halves between two e4m3 values (ties: round to even) and
    # values far below the vector's max (subnormal codes)
    x.reshape(-1)[:6] = [448.0, 1.0625, -1.1875, 3e-3, -2e-4, 0.0]
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = t(x).to(getattr(torch, dtype))
    jq, js = jqm.quantize_channel(jx, axis=axis, dtype="fp8")
    tq, ts = tqm.quantize_channel(tx, axis=axis, dtype="fp8")
    assert tq.dtype == E4M3 and ts.dtype == torch.float32
    np.testing.assert_array_equal(codes(tq), codes(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("shape", [(5, 3, 64), (2, 7, 4, 128), (16,)])
def test_fp8_quantize_kv_matches_jax(shape):
    rng = np.random.RandomState(len(shape))
    x = (rng.randn(*shape) * 0.7).astype(np.float32)
    tq, ts = tqm.quantize_kv(t(x), "fp8")
    jq, js = jqm.quantize_kv(jnp.asarray(x), "fp8")
    np.testing.assert_array_equal(codes(tq), codes(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tqm.dequantize_kv(tq, ts).numpy(),
                                  np.asarray(jqm.dequantize_kv(jq, js)))
    # every code is finite and within ±448; the vector's max lands on it
    deq = tq.float()
    assert torch.isfinite(deq).all() and deq.abs().max() <= 448.0
    assert (deq.abs().amax(-1) == 448.0).all()


def test_fp8_mode_names_match_jax(monkeypatch):
    for name in ("fp8", "FP8", " fp8 ", "int8", None, "", "bf16"):
        assert tqm.resolve_kv_quant(name) == jqm.resolve_kv_quant(name)
    monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", "fp8")
    assert tqm.resolve_kv_quant() == jqm.resolve_kv_quant() == "fp8"
    assert tqm.kv_storage_dtype("fp8") == E4M3
    assert tqm.kv_quant_mode(E4M3) == "fp8"
    assert jqm.kv_quant_mode(jqm.kv_storage_dtype("fp8")) == "fp8"
    assert tqm._qmax("fp8") == jqm._qmax("fp8") == 448.0
    with pytest.raises(ValueError):
        tqm.kv_quant_mode(torch.float8_e5m2)
    k, v, ks, vs = tqm.kv_zeros((2, 8, 2, 64), "fp8", torch.float32, "cpu")
    assert k.dtype == v.dtype == E4M3 and tuple(ks.shape) == (2, 8, 2)


# ---- quantized matmul --------------------------------------------------

def operands(m, k, n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, k).astype(np.float32),
            (rng.randn(k, n) * 0.3).astype(np.float32))


@pytest.mark.parametrize("m,k,n", [(32, 256, 128), (8, 512, 384),
                                   (33, 128, 256), (1, 384, 128)])
def test_fp8_quantized_matmul_matches_jax_composite(m, k, n):
    x, w = operands(m, k, n, m + k + n)
    jqx, jsx = jqm.quantize_channel(jnp.asarray(x), axis=1, dtype="fp8")
    jqw, jsw = jqm.quantize_channel(jnp.asarray(w), axis=0, dtype="fp8")
    ref = np.asarray(jqm._qmm_composite(jqx, jqw, jsx, jsw, jnp.float32))
    scale = np.abs(ref).max()
    got = tqm._qmm_plain(t(jqx), t(jqw), t(jsx), t(jsw),
                         torch.float32).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * scale
    # the public op from the raw operands, quantization included
    y = tqm.quantized_matmul(t(x), t(w), dtype="fp8").numpy()
    jy = np.asarray(jqm.quantized_matmul(jnp.asarray(x), jnp.asarray(w),
                                         dtype="fp8"))
    assert np.abs(y - jy).max() <= 1e-5 * np.abs(jy).max()
    bf = tqm.quantized_matmul(t(x), t(w), dtype="fp8",
                              out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16


def test_fp8_fake_quant_matmul_grads_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 96).astype(np.float32)
    w = (rng.randn(96, 40) * 0.3).astype(np.float32)
    g = rng.randn(2, 6, 40).astype(np.float32)

    def loss(a, b):
        return jnp.sum(jqm.fake_quant_matmul(a, b, "fp8") * g)

    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = t(x).requires_grad_(), t(w).requires_grad_()
    y = tqm.fake_quant_matmul(xt, wt, "fp8")
    ref_y = np.asarray(jqm.fake_quant_matmul(jnp.asarray(x), jnp.asarray(w),
                                             "fp8"))
    assert np.abs(y.detach().numpy() - ref_y).max() <= \
        1e-5 * np.abs(ref_y).max()
    (y * t(g)).sum().backward()
    for got, ref in ((xt.grad, gx), (wt.grad, gw)):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()


# ---- attention over e4m3 caches ----------------------------------------

def jit_ref(fn, args):
    """A JAX composite under ``jax.jit`` (one compile, not one per eager
    op) on numpy arguments; it is what the JAX entry points run for fp8
    caches (their kernel gates take int8 only)."""
    return np.asarray(jax.jit(fn)(*(jnp.asarray(a) for a in args)))


def fp8_cache(rng, b, s, hkv, d):
    k = (rng.randn(b, s, hkv, d) * 0.5).astype(np.float32)
    v = (rng.randn(b, s, hkv, d) * 0.5).astype(np.float32)
    kq, ks = jqm.quantize_kv(jnp.asarray(k), "fp8")
    vq, vs = jqm.quantize_kv(jnp.asarray(v), "fp8")
    return [np.asarray(a) for a in (kq, vq, ks, vs)]


def paged_of(arrays, bs, seed):
    """Dense ``[B, S, ...]`` arrays scattered over a shuffled block pool
    (block 0 the null block), tables one entry wider than needed."""
    b, s = arrays[0].shape[:2]
    mb = s // bs
    perm = 1 + np.random.RandomState(seed).permutation(b * mb)
    tables = np.zeros((b, mb + 1), np.int32)
    tables[:, :mb] = perm.reshape(b, mb)

    def scatter(x):
        pool = np.zeros((b * mb + 1, bs) + x.shape[2:], x.dtype)
        for i in range(b):
            for jb in range(mb):
                pool[tables[i, jb]] = x[i, jb * bs:(jb + 1) * bs]
        return pool
    return [scatter(x) for x in arrays], tables


@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (16, 1)])
def test_fp8_decode_plain_matches_jax_composite(h, hkv):
    """Dense and paged decode over e4m3 caches, G up to 16, lengths 1 to
    S: the port's plain versions against the composites JAX runs for
    fp8."""
    b, s, d = 4, 128, 64
    rng = np.random.RandomState(h * 10 + hkv)
    q = (rng.randn(b, h, d) * 0.5).astype(np.float32)
    kq, vq, ks, vs = fp8_cache(rng, b, s, hkv, d)
    lengths = np.asarray([1, 37, 100, s], np.int32)
    args = (q, kq, vq, lengths, ks, vs)
    out = tda.decode_attention(*(t(a) for a in args)).numpy()
    np.testing.assert_allclose(out, jit_ref(jda._decode_composite, args),
                               **TOL)
    (pk, pv, pks, pvs), tables = paged_of([kq, vq, ks, vs], 16, h + hkv)
    pargs = (q, pk, pv, tables, lengths, pks, pvs)
    pout = tda.paged_decode_attention(*(t(a) for a in pargs)).numpy()
    np.testing.assert_allclose(pout, jit_ref(jda._paged_composite, pargs),
                               **TOL)
    np.testing.assert_allclose(pout, out, **TOL)


@pytest.mark.parametrize("w,hkv", [(1, 4), (3, 2), (8, 1)])
def test_fp8_window_plain_matches_jax_composite(w, hkv):
    """The window entry points (spec verify, prefill chunk) over dense and
    paged e4m3 caches, lengths 0 (the window is its own first key), mid
    and S - W."""
    b, s, h, d = 3, 128, 4, 64
    rng = np.random.RandomState(w * 10 + hkv)
    q = (rng.randn(b, w, h, d) * 0.3).astype(np.float32)
    kq, vq, ks, vs = fp8_cache(rng, b, s, hkv, d)
    lengths = np.asarray([0, 37, s - w], np.int32)
    args = (q, kq, vq, lengths, ks, vs)
    out = tda.decode_attention_window(*(t(a) for a in args)).numpy()
    np.testing.assert_allclose(out, jit_ref(jda._window_composite, args),
                               **TOL)
    (pk, pv, pks, pvs), tables = paged_of([kq, vq, ks, vs], 16, w)
    pargs = (q, pk, pv, tables, lengths, pks, pvs)
    pout = tda.paged_decode_attention_window(*(t(a) for a in pargs)).numpy()
    np.testing.assert_allclose(
        pout, jit_ref(jda._paged_window_composite, pargs), **TOL)


def test_fp8_plain_rounds_dequantized_values_to_q_dtype():
    """In bf16 the plain versions dequantize e4m3 to q's dtype before the
    dots, as the composites do: equal to the bf16 cache version fed the
    rounded values."""
    rng = np.random.RandomState(4)
    kq, vq, ks, vs = (t(a) for a in fp8_cache(rng, 2, 32, 2, 64))
    q = t(rng.randn(2, 4, 64).astype(np.float32)).bfloat16()
    lens = torch.tensor([7, 32], dtype=torch.int32)
    got = tda.decode_attention(q, kq, vq, lens, ks, vs)
    want = tda.decode_attention(q, tqm.dequantize_kv(kq, ks, torch.bfloat16),
                                tqm.dequantize_kv(vq, vs, torch.bfloat16),
                                lens)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["mixed_codes", "scale_dtype", "no_scale",
                                  "e5m2", "window_mixed", "qmm_mixed",
                                  "qmm_width"])
def test_fp8_kernels_reject_what_they_cannot_take(case):
    """The e4m3 kernels' wrappers check before any launch (reachable on
    the CPU): e4m3 K with int8 V, f16 scales, codes without scales, e5m2
    codes, a mixed window cache, e4m3 activations with int8 weights, N not
    a multiple of 128."""
    q = torch.zeros(2, 8, 64, dtype=torch.bfloat16)
    k8 = torch.zeros(2, 32, 4, 64, dtype=E4M3)
    ks = torch.zeros(2, 32, 4)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises((ValueError, TypeError)):
        if case == "mixed_codes":
            tda._decode_cuda(q, k8, k8.view(torch.int8), lens, ks, ks)
        elif case == "scale_dtype":
            tda._decode_cuda(q, k8, k8, lens, ks.half(), ks.half())
        elif case == "no_scale":
            tda._decode_cuda(q, k8, k8, lens, None, None)
        elif case == "e5m2":
            k5 = torch.zeros(2, 32, 4, 64, dtype=torch.float8_e5m2)
            tda._decode_cuda(q, k5, k5, lens, ks, ks)
        elif case == "window_mixed":
            tda._window_cuda(q[:, None], k8, k8.view(torch.int8), lens, ks,
                             ks)
        elif case == "qmm_mixed":
            tqm._qmm_cuda(torch.zeros(8, 128, dtype=E4M3),
                          torch.zeros(128, 128, dtype=torch.int8),
                          torch.ones(8, 1), torch.ones(1, 128),
                          torch.bfloat16)
        else:
            tqm._qmm_cuda(torch.zeros(8, 128, dtype=E4M3),
                          torch.zeros(96, 128, dtype=E4M3),
                          torch.ones(8, 1), torch.ones(1, 96),
                          torch.bfloat16)


# ---- the error ratio that sets TOL_TEACHER_FP8 -------------------------

RATIO_CFG = dict(vocab_size=97, hidden_size=128, num_layers=2, num_heads=4,
                 max_seq_len=64, initializer_range=0.2)


def jax_teacher_error(jm, ids, kv_dtype, plen):
    """The JAX model's prefill of ``plen`` tokens and decode steps over
    the rest against its no-cache forward: the worst position's
    max |diff| / max |logit|."""
    ref = np.asarray(jax.jit(lambda i: jm(paddle.Tensor(i)).data)(
        jnp.asarray(ids)))[0]
    cache = jm.init_kv_cache(1, kv_dtype=kv_dtype)
    padded = np.zeros((1, 32), np.int32)
    padded[0, :plen] = ids[0, :plen]
    logits, cache = jax.jit(lambda i, c: jm.prefill(i, c, 0, plen))(
        jnp.asarray(padded), cache)
    got = [np.asarray(logits)[0]]
    step = jax.jit(lambda tok, c: jm.decode_step(
        tok, c, jnp.ones(1, jnp.int32)))
    for pos in range(plen, ids.shape[1] - 1):
        logits, cache = step(jnp.asarray(ids[:, pos]), cache)
        got.append(np.asarray(logits)[0])
    got = np.stack(got)
    want = ref[plen - 1:plen - 1 + got.shape[0]]
    return (np.abs(got - want).max(-1) / np.abs(want).max(-1)).max()


def test_error_ratio_sets_tol_teacher_fp8():
    """chip_smoke's TOL_TEACHER_FP8 is twice FP8_TEACHER_WORST, the worst
    teacher-forced error its ``--fp8-teacher-error`` mode measured over
    an fp8 cache at full depth, rounded up to two significant digits; and
    it is tighter than the bound the JAX model's own fp8 / int8 error
    ratio gives (TOL_TEACHER_INT8 times the ratio of its teacher-forced
    error over an fp8 cache to its error over an int8 cache: a 2-layer,
    hidden-128 model, 24 prompt tokens and 16 decode steps, on the
    CPU)."""
    paddle.seed(0)
    jm = JaxGPT(JaxConfig(**RATIO_CFG))
    jm.eval()
    ids = np.random.RandomState(12).randint(0, 97, (1, 41)).astype(np.int32)
    e_int8 = jax_teacher_error(jm, ids, "int8", 24)
    e_fp8 = jax_teacher_error(jm, ids, "fp8", 24)
    ratio = e_fp8 / e_int8
    src = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()

    def const(name):
        return float(re.search(rf"^{name} = ([0-9.e+-]+)", src, re.M)[1])
    tol_int8, tol_fp8 = const("TOL_TEACHER_INT8"), const("TOL_TEACHER_FP8")
    worst = const("FP8_TEACHER_WORST")
    assert e_fp8 > e_int8 > 0, (e_fp8, e_int8)
    digit = 10.0 ** (math.floor(math.log10(2 * worst)) - 1)
    assert math.isclose(tol_fp8, math.ceil(2 * worst / digit) * digit), \
        (worst, tol_fp8)
    assert 2 * worst <= tol_fp8 < tol_int8 * ratio, (ratio, tol_fp8)
