"""The port's attention ops against the JAX package, on the CPU.

On the CPU the port's wrappers run their plain PyTorch versions; these
tests hold them, in f32, to the JAX composites (``_composite``,
``_decode_composite``) and to the Pallas kernels run in interpret mode
(``_fwd_gqa``, ``_decode_gqa``), on the same numpy inputs.  f32 on both
sides with highest-precision JAX matmuls, so the tolerances are f32
rounding: 2e-5 on outputs (as tests/test_flash_attention.py), 1e-4
absolute on lse (values up to ~10).  The JAX references run staged
under ``jax.jit``, one program a shape: eagerly the composite compiles
each op and interpret mode walks the kernel's grid from Python.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import functools
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

jfa = importlib.import_module("paddle_tpu.ops.flash_attention")
jda = importlib.import_module("paddle_tpu.ops.decode_attention")
tfa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
tda = importlib.import_module("paddle_tpu_torch.ops.decode_attention")

TOL = dict(rtol=2e-5, atol=2e-5)

_composite = jax.jit(jfa._composite, static_argnums=(3,))
_fwd_gqa = jax.jit(jfa._fwd_gqa, static_argnums=(4,))
_bwd_gqa = jax.jit(jfa._bwd_gqa, static_argnums=(7,))
_decode_composite = jax.jit(jda._decode_composite)
_decode_kernel = jax.jit(jda.decode_attention)


@functools.partial(jax.jit, static_argnums=(5,))
def _composite_vjp(q, k, v, do, mask, causal):
    _, vjp = jax.vjp(lambda a, b, c: jfa._composite(a, b, c, causal, mask),
                     q, k, v)
    return vjp(do)


@functools.partial(jax.jit, static_argnums=(3,))
def _masked_lse(q, k, mask, causal):
    """The masked log-sum-exp formed in JAX: -1e30 for masked scores,
    ``m + log(max(l, 1e-30))``."""
    s, h, d = q.shape[1], q.shape[2], q.shape[3]
    kr = jnp.repeat(k, h // k.shape[2], axis=2)
    sc = jnp.einsum("bqhd,bkhd->bhqk", q, kr, precision="highest") / np.sqrt(d)
    keep = jnp.ones((s, s), bool)
    if causal:
        keep = jnp.tril(keep)
    keep = keep[None, None]
    if mask is not None:
        keep = keep & (mask[:, None, None, :] > 0)
    sc = jnp.where(keep, sc, -1e30)
    mx = sc.max(-1)
    l = jnp.where(sc <= -0.5e30, 0.0, jnp.exp(sc - mx[..., None])).sum(-1)
    return mx + jnp.log(jnp.maximum(l, 1e-30))


@pytest.fixture
def interpret():
    jfa.set_interpret_mode(True)
    yield
    jfa.set_interpret_mode(False)


def make_qkv(b, s, h, hkv, d, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, s, h, d) * 0.5).astype(np.float32)
    k = (rng.randn(b, s, hkv, d) * 0.5).astype(np.float32)
    v = (rng.randn(b, s, hkv, d) * 0.5).astype(np.float32)
    return q, k, v


def key_mask(b, s, seed):
    """Random key padding, plus one batch row whose key 0 is masked so
    causal row 0 is fully masked (must give exact zeros)."""
    m = (np.random.RandomState(seed + 1).rand(b, s) > 0.25).astype(np.float32)
    m[-1, 0] = 0.0
    return m


@pytest.mark.parametrize("s", [16, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_jax(causal, g, s, interpret):
    b, hkv, d = 2, 2, 64
    q, k, v = make_qkv(b, s, hkv * g, hkv, d, seed=s + g)
    o, lse = tfa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal)
    ref = _composite(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), **TOL)
    # Pallas kernel in interpret mode: o and the per-row lse
    q4, k3, v3 = jfa._to_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    o4, lse4 = _fwd_gqa(q4, k3, v3, jnp.ones((b, 1, s), jnp.float32),
                        causal)
    np.testing.assert_allclose(
        o.numpy(), np.asarray(jfa._from_gqa_q(o4, b, s, hkv * g, d)), **TOL)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(lse4).reshape(b, hkv * g, s),
        rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_key_mask_matches_jax(causal, interpret):
    b, s, h, hkv, d = 2, 128, 4, 2, 64
    q, k, v = make_qkv(b, s, h, hkv, d, seed=7)
    m = key_mask(b, s, seed=7)
    o, lse = tfa.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, kv_mask=torch.from_numpy(m))
    ref = _composite(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                     jnp.asarray(m))
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), **TOL)
    q4, k3, v3 = jfa._to_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    o4, lse4 = _fwd_gqa(q4, k3, v3, jnp.asarray(m).reshape(b, 1, s), causal)
    np.testing.assert_allclose(
        o.numpy(), np.asarray(jfa._from_gqa_q(o4, b, s, h, d)), **TOL)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(lse4).reshape(b, h, s),
                               rtol=1e-5, atol=1e-4)
    if causal:   # row 0 of the last batch row sees only a masked key
        assert np.all(o.numpy()[-1, 0] == 0.0)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [130, 200])
def test_flash_plain_matches_jax_at_ragged_tiles(s, causal, masked):
    """S past one 128-row tile of the Hopper kernel and not a multiple
    of it (the JAX package takes its composite there): o against
    ``_composite``; lse against the same masked log-sum-exp formed in
    JAX (-1e30 for masked scores, ``m + log(max(l, 1e-30))``)."""
    b, h, hkv, d = 2, 4, 2, 64
    q, k, v = make_qkv(b, s, h, hkv, d, seed=s + causal)
    m = key_mask(b, s, seed=s) if masked else None
    o, lse = tfa.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, kv_mask=None if m is None else torch.from_numpy(m))
    jm = None if m is None else jnp.asarray(m)
    ref = _composite(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                     jm)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        lse.numpy(),
        np.asarray(_masked_lse(jnp.asarray(q), jnp.asarray(k), jm, causal)),
        rtol=1e-5, atol=1e-4)
    if masked and causal:   # row 0 of the last batch row sees no key
        assert np.all(o.numpy()[-1, 0] == 0.0)


@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_decode_plain_matches_jax(hkv):
    b, s, h, d = 4, 256, 4, 64
    rng = np.random.RandomState(hkv)
    q = (rng.randn(b, h, d) * 0.5).astype(np.float32)
    k = (rng.randn(b, s, hkv, d) * 0.5).astype(np.float32)
    v = (rng.randn(b, s, hkv, d) * 0.5).astype(np.float32)
    lengths = np.asarray([0, 1, 100, s], np.int32)
    out = tda.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               torch.from_numpy(lengths)).numpy()
    ref = np.asarray(_decode_composite(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(lengths)))
    # the composite averages uniformly over an empty slot; the kernels
    # (JAX's and the port's) give zeros there
    np.testing.assert_allclose(out[1:], ref[1:], **TOL)
    assert np.all(out[0] == 0.0)
    da_state = jda._STATE["interpret"]
    jda.set_interpret_mode(True)
    try:
        kern = np.asarray(_decode_kernel(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lengths)))
    finally:
        jda.set_interpret_mode(da_state)
    np.testing.assert_allclose(out, kern, **TOL)


def test_decode_plain_ignores_positions_past_length():
    rng = np.random.RandomState(1)
    b, s, hkv, d = 2, 64, 2, 16
    q = torch.from_numpy(rng.randn(b, 4, d).astype(np.float32))
    k = torch.from_numpy(rng.randn(b, s, hkv, d).astype(np.float32))
    v = torch.from_numpy(rng.randn(b, s, hkv, d).astype(np.float32))
    lengths = torch.tensor([5, 9], dtype=torch.int32)
    base = tda.decode_attention(q, k, v, lengths)
    k2, v2 = k.clone(), v.clone()
    k2[:, 10:] = 1e3
    v2[:, 10:] = -1e3
    out = tda.decode_attention(q, k2, v2, lengths)
    torch.testing.assert_close(out, base, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["head_dim", "dtype", "seq_mismatch",
                                  "noncontiguous", "mask_dtype"])
def test_flash_kernel_rejects_what_it_cannot_take(case):
    """The CUDA path raises on shapes/dtypes/layouts the kernel does not
    take (validated before any launch, so checkable on the CPU)."""
    bf = torch.bfloat16
    q = torch.zeros(1, 64, 4, 64, dtype=bf)
    k = torch.zeros(1, 64, 2, 64, dtype=bf)
    v = torch.zeros(1, 64, 2, 64, dtype=bf)
    mask = None
    if case == "head_dim":
        q, k, v = (torch.zeros(*t.shape[:3], 96, dtype=bf) for t in (q, k, v))
    elif case == "dtype":
        q, k, v = q.float(), k.float(), v.float()
    elif case == "seq_mismatch":
        k, v = k[:, :32].contiguous(), v[:, :32].contiguous()
    elif case == "noncontiguous":
        q = torch.zeros(1, 4, 64, 64, dtype=bf).transpose(1, 2)
    elif case == "mask_dtype":
        mask = torch.ones(1, 64, dtype=torch.int32)
    with pytest.raises((ValueError, TypeError)):
        tfa._check_cuda(q, k, v, mask)


def test_ops_refuse_other_devices():
    q = torch.zeros(1, 16, 4, 64, device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        tda.decode_attention(q[:, 0], q, q, torch.zeros(1, dtype=torch.int32,
                                                        device="meta"))


# ---- backward ------------------------------------------------------------
# The port's plain backward against jax.vjp of the JAX composite and
# against the Pallas backward kernels (_bwd_gqa) in interpret mode, on
# the same numpy q, k, v, do.  f32 with highest-precision JAX matmuls;
# tolerance 2e-5 relative to each gradient's scale (its max |ref|), as
# the forward's 2e-5.


def _grad_close(got, ref, name):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= 2e-5 * scale, f"{name}: max err {err:.3e}, scale {scale:.3e}"


def _bwd_case(b, s, h, hkv, d, causal, seed, mask=None):
    q, k, v = make_qkv(b, s, h, hkv, d, seed)
    do = (np.random.RandomState(seed + 100).randn(b, s, h, d) * 0.5
          ).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    o, lse = tfa._flash_plain(tq, tk, tv, causal, tm)
    grads = tfa._flash_bwd_plain(tq, tk, tv, o, lse, torch.from_numpy(do),
                                 causal, tm)
    jm = None if mask is None else jnp.asarray(mask)
    refs = _composite_vjp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(do), jm, causal)
    for name, got, ref in zip("qkv", grads, refs):
        _grad_close(got.numpy(), ref, f"d{name} vs vjp(_composite)")
    # the Pallas backward kernels in interpret mode, on the GQA layout
    q4, k3, v3 = jfa._to_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jmask = jnp.ones((b, 1, s), jnp.float32) if mask is None \
        else jnp.asarray(mask).reshape(b, 1, s)
    o4, lse4 = _fwd_gqa(q4, k3, v3, jmask, causal)
    do4 = jnp.swapaxes(jnp.asarray(do), 1, 2).reshape(b * hkv, h // hkv, s, d)
    dq4, dk3, dv3 = _bwd_gqa(q4, k3, v3, jmask, o4, lse4, do4, causal)
    refs = (jfa._from_gqa_q(dq4, b, s, h, d),
            jnp.swapaxes(dk3.reshape(b, hkv, s, d), 1, 2),
            jnp.swapaxes(dv3.reshape(b, hkv, s, d), 1, 2))
    for name, got, ref in zip("qkv", grads, refs):
        _grad_close(got.numpy(), ref, f"d{name} vs _bwd_gqa")
    return grads


@pytest.mark.parametrize("s", [16, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_plain_matches_jax(causal, g, s, interpret):
    _bwd_case(2, s, 2 * g, 2, 64, causal, seed=s + 10 * g)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_plain_key_mask_matches_jax(causal, interpret):
    b, s, h, hkv, d = 2, 128, 4, 2, 64
    dq, dk, dv = _bwd_case(b, s, h, hkv, d, causal, seed=9,
                           mask=key_mask(b, s, seed=9))
    if causal:   # row 0 of the last batch row sees only a masked key
        assert np.all(dq.numpy()[-1, 0] == 0.0)
    # masked keys get no gradient
    m = key_mask(b, s, seed=9)
    assert np.all(dk.numpy()[m == 0] == 0.0)
    assert np.all(dv.numpy()[m == 0] == 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [16, 77])
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_flash_bwd_delta_plain_matches_jax(h, hkv, s, dtype):
    """``_flash_bwd_delta_plain`` (what the dq kernel writes) against the
    rowsum ``_bwd_gqa`` forms, ``jnp.sum(do4 * o4, -1)`` in f32 on the
    GQA layout, from the same numpy o and do (rounded to bf16 alike on
    both sides for the bf16 case)."""
    b, d = 2, 64
    rng = np.random.RandomState(s + h)
    o, do = ((rng.randn(b, s, h, d) * 0.5).astype(np.float32)
             for _ in range(2))
    to, tdo = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (o, do))
    got = tfa._flash_bwd_delta_plain(to, tdo)
    assert got.dtype == torch.float32 and got.shape == (b, h, s)
    o4, do4 = (jnp.swapaxes(jnp.asarray(a, getattr(jnp, dtype)), 1, 2)
               .reshape(b * hkv, h // hkv, s, d) for a in (o, do))
    ref = jnp.sum(do4.astype(jnp.float32) * o4.astype(jnp.float32), axis=-1)
    _grad_close(got.numpy(), np.asarray(ref).reshape(b, h, s), "delta")


@pytest.mark.parametrize("causal,g,masked", [
    (True, 1, False), (False, 2, True), (True, 2, True)])
def test_flash_autograd_gradcheck_f64(causal, g, masked):
    """The autograd function (plain forward and backward on the CPU)
    passes torch's finite-difference check in f64 at tiny shapes."""
    b, s, hkv, d = 1, 5, 1, 4
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(b, s, n, d)).requires_grad_()
               for n in (hkv * g, hkv, hkv))
    mask = None
    if masked:
        mask = torch.ones(b, s, dtype=torch.float64)
        mask[0, 0] = 0.0
    assert torch.autograd.gradcheck(
        lambda a, bb, c: tfa.flash_attention(a, bb, c, causal, mask),
        (q, k, v))


def test_flash_autograd_matches_autograd_of_plain():
    """Backward of flash_attention (the custom function) equals autograd
    through the plain forward, with a non-contiguous upstream gradient
    as the output projection's reshape gives it."""
    b, s, h, hkv, d = 2, 33, 4, 2, 16
    q, k, v = (torch.from_numpy(a) for a in make_qkv(b, s, h, hkv, d, 5))
    m = torch.from_numpy(key_mask(b, s, seed=5))
    up = torch.from_numpy(np.random.RandomState(6).randn(b, h, s, d)
                          .astype(np.float32)).transpose(1, 2)
    assert not up.is_contiguous()
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    (tfa.flash_attention(*ins, True, m) * up).sum().backward()
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    (tfa._flash_plain(*ref, True, m)[0] * up).sum().backward()
    for a, r in zip(ins, ref):
        torch.testing.assert_close(a.grad, r.grad, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("case", ["o_dtype", "do_shape", "lse_dtype",
                                  "do_noncontiguous"])
def test_flash_bwd_kernel_rejects_what_it_cannot_take(case):
    """The backward's CUDA path validates o, do and lse before any
    launch (checkable on the CPU)."""
    bf = torch.bfloat16
    q = torch.zeros(1, 64, 4, 64, dtype=bf)
    o, do = torch.zeros_like(q), torch.zeros_like(q)
    lse = torch.zeros(1, 4, 64)
    if case == "o_dtype":
        o = o.float()
    elif case == "do_shape":
        do = do[:, :32].contiguous()
    elif case == "lse_dtype":
        lse = lse.to(bf)
    elif case == "do_noncontiguous":
        do = torch.zeros(1, 4, 64, 64, dtype=bf).transpose(1, 2)
    with pytest.raises(ValueError):
        for name, t, shape, dtype in (("o", o, q.shape, q.dtype),
                                      ("do", do, q.shape, q.dtype),
                                      ("lse", lse, (1, 4, 64),
                                       torch.float32)):
            tfa._check_operand(name, t, q, shape, dtype)
