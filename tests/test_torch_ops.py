"""The port's attention ops against the JAX package, on the CPU.

On the CPU the port's wrappers run their plain PyTorch versions; these
tests hold them, in f32, to the JAX composites (``_composite``,
``_decode_composite``) and to the Pallas kernels run in interpret mode
(``_fwd_gqa``, ``_decode_gqa``), on the same numpy inputs.  f32 on both
sides with highest-precision JAX matmuls, so the tolerances are f32
rounding: 2e-5 on outputs (as tests/test_flash_attention.py), 1e-4
absolute on lse (values up to ~10).
"""
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

jfa = importlib.import_module("paddle_tpu.ops.flash_attention")
jda = importlib.import_module("paddle_tpu.ops.decode_attention")
tfa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
tda = importlib.import_module("paddle_tpu_torch.ops.decode_attention")

TOL = dict(rtol=2e-5, atol=2e-5)


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
    ref = jfa._composite(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), **TOL)
    # Pallas kernel in interpret mode: o and the per-row lse
    q4, k3, v3 = jfa._to_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    o4, lse4 = jfa._fwd_gqa(q4, k3, v3, jnp.ones((b, 1, s), jnp.float32),
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
    ref = jfa._composite(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal, jnp.asarray(m))
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), **TOL)
    q4, k3, v3 = jfa._to_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    o4, lse4 = jfa._fwd_gqa(q4, k3, v3, jnp.asarray(m).reshape(b, 1, s),
                            causal)
    np.testing.assert_allclose(
        o.numpy(), np.asarray(jfa._from_gqa_q(o4, b, s, h, d)), **TOL)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(lse4).reshape(b, h, s),
                               rtol=1e-5, atol=1e-4)
    if causal:   # row 0 of the last batch row sees only a masked key
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
    ref = np.asarray(jda._decode_composite(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v),
                                           jnp.asarray(lengths)))
    # the composite averages uniformly over an empty slot; the kernels
    # (JAX's and the port's) give zeros there
    np.testing.assert_allclose(out[1:], ref[1:], **TOL)
    assert np.all(out[0] == 0.0)
    da_state = jda._STATE["interpret"]
    jda.set_interpret_mode(True)
    try:
        kern = np.asarray(jda.decode_attention(
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
