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


def _close(got, ref, tol=1e-2, floor=0.0):
    """Rows along the last axis, each within ``tol`` of its own max |ref|,
    or of ``floor`` x the tensor's max |ref| where that is larger (with
    no floor, an all-zero reference row must come out exactly 0)."""
    err = (got.float() - ref).abs().amax(-1)
    scale = ref.abs().amax(-1).clamp_min(floor * ref.abs().max())
    worst = (err / scale.clamp_min(1e-30)).max().item()
    assert bool((err <= tol * scale).all()), worst


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


@pytest.mark.parametrize("s,h,hkv,d,causal,masked", [
    (256, 16, 16, 128, True, False), (200, 16, 4, 128, True, True),
    (48, 8, 8, 64, False, False), (130, 4, 2, 64, False, True)])
def test_flash_backward_kernels_match_plain(gen, s, h, hkv, d, causal,
                                            masked):
    b = 2
    q = _rand((b, s, h, d), gen)
    k = _rand((b, s, hkv, d), gen)
    v = _rand((b, s, hkv, d), gen)
    do = _rand((b, s, h, d), gen)
    mask = None
    if masked:
        mask = (torch.rand((b, s), generator=gen, device="cuda") > 0.3).float()
        mask[-1, 0] = 0.0         # causal row 0 of the last batch: no key
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, kv_mask=mask)
    n_dq, n_dkv = fa.FLASH_BWD_DQ.launches, fa.FLASH_BWD_DKV.launches
    got = fa._flash_bwd_cuda(q, k, v, o, lse, do, causal, mask)
    again = fa._flash_bwd_cuda(q, k, v, o, lse, do, causal, mask)
    assert fa.FLASH_BWD_DQ.launches == n_dq + 2
    assert fa.FLASH_BWD_DKV.launches == n_dkv + 2
    ref = fa._flash_bwd_plain(q.float(), k.float(), v.float(), o.float(),
                              lse, do.float(), causal, mask)
    for g, a, r in zip(got, again, ref):
        assert torch.equal(g, a)              # no atomics: deterministic
        _close(g, r, tol=2e-2, floor=1e-3)


def test_cuda_flash_attention_is_differentiable(gen):
    """The kernel path stays in the autograd graph: backward reaches q,
    k and v through the dq and dk/dv kernels, with a non-contiguous
    upstream gradient."""
    b, s, h, hkv, d = 2, 96, 8, 4, 64
    q, k, v = (_rand(shape, gen).requires_grad_() for shape in
               ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    out = fa.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    up = _rand((b, h, s, d), gen).transpose(1, 2)
    n_dq = fa.FLASH_BWD_DQ.launches
    out.backward(up)
    assert fa.FLASH_BWD_DQ.launches == n_dq + 1
    o, lse = fa._flash_cuda(q.detach(), k.detach(), v.detach(), True, None)
    ref = fa._flash_bwd_plain(q.detach().float(), k.detach().float(),
                              v.detach().float(), o.float(), lse,
                              up.float(), True, None)
    for t, r in zip((q, k, v), ref):
        assert t.grad is not None and t.grad.dtype == torch.bfloat16
        _close(t.grad, r, tol=2e-2, floor=1e-3)
