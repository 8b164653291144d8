"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where no CUDA device is present (the
CPU test run).  These import neither JAX nor the JAX package, so they
also run on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance, held per output row (one query row of one head, or one
(slot, head) of decode) so that long rows, whose outputs are small, are
held to their own scale: bf16 inputs, the flash kernel rounds p to bf16
before p.v and both round the output to bf16 (relative 2^-8); the plain
version runs in f32 on the same inputs, so each row's error is about
2^-8 of its largest element: 1e-2 x max|ref row|.  lse: 1e-3 x
max(1, |ref lse|) per row.
"""
import importlib

import pytest
import torch

pytestmark = pytest.mark.cuda

fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
da = importlib.import_module("paddle_tpu_torch.ops.decode_attention")


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _rand(shape, gen):
    return torch.randn(shape, generator=gen, device="cuda").bfloat16()


def _close(got, ref):
    """Rows along the last axis, each within 1e-2 of its own max |ref|
    (an all-zero reference row must come out exactly 0)."""
    err = (got.float() - ref).abs().amax(-1)
    scale = ref.abs().amax(-1)
    worst = (err / scale.clamp_min(1e-30)).max().item()
    assert bool((err <= 1e-2 * scale).all()), worst


@pytest.mark.parametrize("s,h,hkv,d,causal", [
    (16, 16, 16, 128, True), (77, 16, 4, 128, True), (128, 8, 8, 64, True),
    (300, 4, 2, 64, False)])
def test_flash_kernel_matches_plain(gen, s, h, hkv, d, causal):
    q = _rand((2, s, h, d), gen)
    k = _rand((2, s, hkv, d), gen)
    v = _rand((2, s, hkv, d), gen)
    launches = fa.FLASH_FWD.launches
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    assert fa.FLASH_FWD.launches == launches + 1
    ro, rlse = fa._flash_plain(q.float(), k.float(), v.float(), causal)
    _close(o, ro)
    assert bool(((lse - rlse).abs() <= 1e-3 * rlse.abs().clamp_min(1.0)).all())


@pytest.mark.parametrize("hkv,d", [(16, 128), (4, 128), (8, 64)])
def test_decode_kernel_matches_plain(gen, hkv, d):
    lengths = [0, 1, 63, 64, 500, 1024]
    q = _rand((len(lengths), 16, d), gen)
    kc = _rand((len(lengths), 1024, hkv, d), gen)
    vc = _rand((len(lengths), 1024, hkv, d), gen)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    o = da.decode_attention(q, kc, vc, lens)
    _close(o, da._decode_plain(q.float(), kc.float(), vc.float(), lens))
    assert o[0].abs().max().item() == 0.0


def test_cuda_path_raises_instead_of_falling_back(gen):
    q = _rand((1, 64, 4, 96), gen)        # D=96: no kernel
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    q = _rand((2, 8, 64), gen)
    kc = _rand((2, 128, 8, 64), gen)
    with pytest.raises(TypeError):        # int64 lengths
        da.decode_attention(q, kc, kc, torch.ones(2, dtype=torch.long,
                                                  device="cuda"))
