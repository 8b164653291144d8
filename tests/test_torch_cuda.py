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
max(1, |ref lse|) per row.  The int8 decode kernels (dense and paged)
are held to the same 1e-2: they dequantize code x scale in f32, and so
does the plain version fed the same codes and an f32 q.  The window
kernels (1e-2 as well) dequantize int8 codes to bf16 before their
products, as the TPU kernel does; their plain version runs in f32 over
the same bf16 values.  The e4m3 kernels (rows 5f-9bf) are held to the
same 1e-2 on the same grounds (every e4m3 code is exact in f16 and f32);
the e4m3 matmul (row 10f) to 1e-3 of each row's max |y| in f32 (exact
products, f32 sums in another order than the plain version's), its
16-bit outputs its f32 output rounded, and its graph replays to eager
bit for bit.
"""
import importlib
import threading

import pytest
import torch

pytestmark = pytest.mark.cuda

fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
da = importlib.import_module("paddle_tpu_torch.ops.decode_attention")
qm = importlib.import_module("paddle_tpu_torch.ops.quantized_matmul")


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _rand(shape, gen, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


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


@pytest.mark.parametrize("b,s,h,hkv,d,dtype,masked", [
    (2, 16, 16, 16, 128, "bfloat16", False),
    (2, 130, 16, 4, 128, "bfloat16", False),        # ragged past one tile
    (1, 2048, 16, 16, 128, "bfloat16", False),
    (4, 2048, 16, 16, 128, "bfloat16", False),      # the training shape
    (2, 200, 8, 2, 64, "float16", False),
    (2, 130, 8, 8, 128, "float16", True),
    (2, 333, 16, 4, 128, "bfloat16", True)])
def test_flash_kernel_on_the_wgmma_mainloop(gen, b, s, h, hkv, d, dtype,
                                            masked):
    """The forward on the shared wgmma mainloop: causal, o per row within
    1e-2, lse within 1e-3, two calls bitwise equal; with a key mask the
    last batch row's key 0 is masked, so its causal row 0 sees no key
    and must be exactly 0."""
    dt = getattr(torch, dtype)
    q = _rand((b, s, h, d), gen).to(dt)
    k = _rand((b, s, hkv, d), gen).to(dt)
    v = _rand((b, s, hkv, d), gen).to(dt)
    mask = None
    if masked:
        mask = (torch.rand((b, s), generator=gen, device="cuda") > 0.3).float()
        mask[-1, 0] = 0.0
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True, kv_mask=mask)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, causal=True, kv_mask=mask)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ro, rlse = fa._flash_plain(q.float(), k.float(), v.float(), True, mask)
    _close(o, ro)
    assert bool(((lse - rlse).abs() <= 1e-3 * rlse.abs().clamp_min(1.0)).all())
    if masked:
        assert o[-1, 0].abs().max().item() == 0.0


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


def test_decode_kernel_group_of_16(gen):
    """G = H / Hkv = 16 (16 query heads over one kv head), which the JAX
    package serves: the group is split over two blocks of 8 rows."""
    lengths = [1, 300, 1024]
    q = _rand((3, 16, 128), gen)
    kc = _rand((3, 1024, 1, 128), gen)
    vc = _rand((3, 1024, 1, 128), gen)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    n = da.DECODE_ATTENTION.launches
    o = da.decode_attention(q, kc, vc, lens)
    assert da.DECODE_ATTENTION.launches == n + 1
    _close(o, da._decode_plain(q.float(), kc.float(), vc.float(), lens))


def _int8(x):
    """bf16 values -> int8 codes and f32 scales (``quantize_kv``)."""
    qm = importlib.import_module("paddle_tpu_torch.ops.quantized_matmul")
    return qm.quantize_kv(x)


@pytest.mark.parametrize("h,hkv,d", [(16, 16, 128), (16, 4, 128), (8, 8, 64),
                                     (16, 1, 128)])
def test_decode_int8_kernel_matches_plain(gen, h, hkv, d):
    """Row 5: int8 codes and f32 scales dequantized in the kernel; the
    plain version fed the same codes dequantizes in f32 (q in f32)."""
    lengths = [0, 1, 63, 64, 500, 1024]
    q = _rand((len(lengths), h, d), gen)
    kc, ks = _int8(_rand((len(lengths), 1024, hkv, d), gen))
    vc, vs = _int8(_rand((len(lengths), 1024, hkv, d), gen))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    n = da.DECODE_ATTENTION_Q.launches
    o = da.decode_attention(q, kc, vc, lens, ks, vs)
    assert da.DECODE_ATTENTION_Q.launches == n + 1
    _close(o, da._decode_plain(q.float(), kc, vc, lens, ks, vs))
    assert o[0].abs().max().item() == 0.0


def _paged_case(gen, lengths, nb, bs, h, hkv, d, quantized):
    """Pools of ``nb`` blocks, each slot's blocks drawn at random without
    repeats (null block 0 past its extent); the last slot is inactive:
    table row all 0 and length 1."""
    b = len(lengths)
    mb = max(-(-n // bs) for n in lengths)
    q = _rand((b, h, d), gen)
    k = _rand((nb, bs, hkv, d), gen)
    v = _rand((nb, bs, hkv, d), gen)
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(b))
    tables = torch.zeros((b, mb), dtype=torch.int32)
    used = 0
    for i, n in enumerate(lengths[:-1]):
        need = -(-n // bs)
        tables[i, :need] = 1 + perm[used:used + need]
        used += need
    tables = tables.cuda()
    lens = torch.tensor(lengths[:-1] + [1], dtype=torch.int32, device="cuda")
    scales = (None, None)
    if quantized:
        (k, ks), (v, vs) = _int8(k), _int8(v)
        scales = (ks, vs)
    return q, k, v, tables, lens, scales


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("bs,h,hkv,d", [(128, 16, 16, 128), (16, 16, 4, 128),
                                        (32, 8, 8, 64), (128, 16, 1, 128)])
def test_paged_kernels_match_plain(gen, quantized, bs, h, hkv, d):
    """Rows 6 and 7: shuffled, non-contiguous blocks, a length of one, an
    exact block multiple, a ragged tail and an inactive slot."""
    lengths = [1, 4 * bs, 3 * bs + 5, 0]
    q, k, v, tables, lens, (ks, vs) = _paged_case(gen, lengths, 40, bs, h,
                                                  hkv, d, quantized)
    kern = da.PAGED_DECODE_ATTENTION_Q if quantized else \
        da.PAGED_DECODE_ATTENTION
    n = kern.launches
    o = da.paged_decode_attention(q, k, v, tables, lens, ks, vs)
    assert kern.launches == n + 1
    ref = da._paged_plain(q.float(), k if quantized else k.float(),
                          v if quantized else v.float(), tables, lens, ks, vs)
    _close(o, ref)


def test_cuda_path_raises_instead_of_falling_back(gen):
    q = _rand((1, 64, 4, 96), gen)        # D=96: no kernel
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    q = _rand((2, 8, 64), gen)
    kc = _rand((2, 128, 8, 64), gen)
    with pytest.raises(TypeError):        # int64 lengths
        da.decode_attention(q, kc, kc, torch.ones(2, dtype=torch.long,
                                                  device="cuda"))


@pytest.mark.parametrize("case", ["dtype", "layout", "group"])
def test_int8_and_paged_paths_raise_instead_of_falling_back(gen, case):
    """A bad dtype (f32 q), layout (block size 8) or group (H % Hkv != 0)
    raises on the card before any launch."""
    b, h, hkv, d, bs = 2, 8, 4, 64, 16
    q = _rand((b, h, d), gen)
    k = _rand((6, bs, hkv, d), gen)
    if case == "dtype":
        q = q.float()
    elif case == "layout":
        k = _rand((6, 8, hkv, d), gen)
    elif case == "group":
        k = _rand((6, bs, 3, d), gen)
    kq, ks = _int8(k)
    tables = torch.ones((b, 2), dtype=torch.int32, device="cuda")
    lens = torch.full((b,), 5, dtype=torch.int32, device="cuda")
    counts = [kern.launches for kern in (da.PAGED_DECODE_ATTENTION,
                                         da.PAGED_DECODE_ATTENTION_Q,
                                         da.DECODE_ATTENTION_Q)]
    with pytest.raises((ValueError, TypeError)):
        da.paged_decode_attention(q, k, k, tables, lens)
    with pytest.raises((ValueError, TypeError)):
        da.paged_decode_attention(q, kq, kq, tables, lens, ks, ks)
    if case != "layout":
        dense = kq.reshape(b, -1, kq.shape[2], d)
        dense_s = ks.reshape(b, -1, ks.shape[2])
        with pytest.raises((ValueError, TypeError)):
            da.decode_attention(q, dense, dense, lens, dense_s, dense_s)
    assert counts == [kern.launches for kern in (
        da.PAGED_DECODE_ATTENTION, da.PAGED_DECODE_ATTENTION_Q,
        da.DECODE_ATTENTION_Q)]


def _bwd_inputs(gen, b, s, h, hkv, d, dtype):
    return (_rand(shape, gen).to(dtype) for shape in
            ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d)))


@pytest.mark.parametrize("s,h,hkv,d,causal,masked,dtype", [
    (256, 16, 16, 128, True, False, "bfloat16"),
    (200, 16, 4, 128, True, True, "bfloat16"),
    (48, 8, 8, 64, False, False, "bfloat16"),
    (130, 4, 2, 64, False, True, "bfloat16"),
    (200, 16, 4, 128, True, True, "float16"),
    (130, 4, 2, 64, False, True, "float16"),
    (512, 16, 1, 128, True, False, "bfloat16"),       # G = 16
    (333, 8, 8, 128, True, False, "bfloat16")])       # ragged: 333 % 128
def test_flash_backward_kernels_match_plain(gen, s, h, hkv, d, causal,
                                            masked, dtype):
    b = 2
    q, k, v, do = _bwd_inputs(gen, b, s, h, hkv, d, getattr(torch, dtype))
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
    assert torch.equal(got[3], again[3])


@pytest.mark.parametrize("s,h,hkv,d,dtype", [
    (256, 16, 16, 128, "bfloat16"), (333, 8, 2, 64, "float16"),
    (77, 4, 4, 128, "float16")])
def test_flash_backward_delta_matches_plain(gen, s, h, hkv, d, dtype):
    """The delta the dq kernel writes (rowsum do . o in f32) against the
    plain delta per row: products of 16-bit values are exact in f32, so
    only the order of the D additions differs, at most (D - 1) 2^-24 x
    sum|do o| (7.6e-6 at D = 128): held to 1e-5 of that sum."""
    b = 2
    q, k, v, do = _bwd_inputs(gen, b, s, h, hkv, d, getattr(torch, dtype))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    delta = fa._flash_bwd_cuda(q, k, v, o, lse, do, True, None)[3]
    ref = fa._flash_bwd_delta_plain(o.float(), do.float())
    scale = fa._flash_bwd_delta_plain(o.float().abs(), do.float().abs())
    assert delta.shape == (b, h, s) and delta.dtype == torch.float32
    err = (delta - ref).abs()
    assert bool((err <= 1e-5 * scale).all()), \
        (err / scale.clamp_min(1e-30)).max().item()


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


@pytest.mark.parametrize("s,h,hkv,d,causal,masked,dtype", [
    (48, 16, 16, 128, True, False, "bfloat16"),
    (333, 8, 2, 128, True, True, "bfloat16"),        # ragged, GQA
    (200, 4, 1, 64, False, True, "float16"),
    (512, 16, 1, 128, True, False, "float16")])      # G = 16
def test_flash_dropout_kernels_match_plain(gen, s, h, hkv, d, causal,
                                           masked, dtype):
    """Rows 1-3's dropout forms (p = 0.1) against their plain versions
    fed the same (seed, offset) pair: o within 1e-2 and dq, dk, dv within
    2e-2 of each row's scale, as without dropout; each kernel
    deterministic for a pair."""
    from paddle_tpu_torch.core import random as prandom
    b, p = 2, 0.1
    q, k, v, do = _bwd_inputs(gen, b, s, h, hkv, d, getattr(torch, dtype))
    mask = None
    if masked:
        mask = (torch.rand((b, s), generator=gen, device="cuda") > 0.3).float()
        mask[:, 0] = 1.0
    pair = prandom.philox_pair("cuda", gen)
    n = [x.launches for x in (fa.FLASH_FWD_DROPOUT, fa.FLASH_BWD_DQ_DROPOUT,
                              fa.FLASH_BWD_DKV_DROPOUT)]
    o, lse = fa._flash_cuda(q, k, v, causal, mask, p, pair)
    got = fa._flash_bwd_cuda(q, k, v, o, lse, do, causal, mask, p, pair)
    again = fa._flash_bwd_cuda(q, k, v, o, lse, do, causal, mask, p, pair)
    assert [x.launches for x in (fa.FLASH_FWD_DROPOUT,
                                 fa.FLASH_BWD_DQ_DROPOUT,
                                 fa.FLASH_BWD_DKV_DROPOUT)] == \
        [n[0] + 1, n[1] + 2, n[2] + 2]
    qf, kf, vf = q.float(), k.float(), v.float()
    ro, rlse = fa._flash_plain(qf, kf, vf, causal, mask, p, pair)
    _close(o, ro)
    assert bool(((lse - rlse).abs() <= 1e-3 * rlse.abs().clamp_min(1.0)).all())
    ref = fa._flash_bwd_plain(qf, kf, vf, o.float(), lse, do.float(), causal,
                              mask, p, pair)
    for g, a, r in zip(got, again, ref):
        assert torch.equal(g, a)
        _close(g, r, tol=2e-2, floor=1e-3)


def test_flash_dropout_bits_on_the_card(gen):
    """philox.cuh's words equal curand_Philox4x32_10's and the plain
    version's; the keep bits it gives each element equal keep_mask's."""
    from paddle_tpu_torch.core import random as prandom
    from paddle_tpu_torch.ops import _philox
    ins = torch.randint(-2 ** 31, 2 ** 31 - 1, (512, 6), generator=gen,
                        device="cuda", dtype=torch.int32)
    ins[0] = 0
    words = _philox.philox_words_cuda(ins).cpu().long() & 0xFFFFFFFF
    assert torch.equal(words[:, :4], words[:, 4:])
    plain = torch.stack(_philox.philox4x32_10(
        *(ins[:, c].cpu().long() & 0xFFFFFFFF for c in range(6))), 1)
    assert torch.equal(words[:, :4], plain)
    assert words[0, :4].tolist() == [0x6627e8d5, 0xe169c58d, 0xbc57ac4c,
                                     0x9b00dbd8]
    pair = prandom.philox_pair("cuda", gen)
    assert torch.equal(_philox.keep_bits_cuda(pair, 2, 3, 200, 200, 0.1),
                       _philox.keep_mask(pair, 2, 3, 200, 200, 0.1))


def test_cuda_flash_dropout_is_differentiable_and_fresh(gen):
    """flash_attention with dropout_p on the card: the backward runs the
    dropout forms with the forward's pair (gradients equal the plain
    backward on the pair drawn from the same default-generator state),
    and the next call draws other bits."""
    from paddle_tpu_torch.core import random as prandom
    b, s, h, hkv, d = 2, 96, 8, 4, 64
    q, k, v = (_rand(shape, gen).requires_grad_() for shape in
               ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    torch.cuda.manual_seed(9)
    out = fa.flash_attention(q, k, v, causal=True, dropout_p=0.1)
    up = _rand((b, s, h, d), gen)
    out.backward(up)
    torch.cuda.manual_seed(9)
    pair = prandom.philox_pair("cuda")
    o, lse = fa._flash_cuda(q.detach(), k.detach(), v.detach(), True, None,
                            0.1, pair)
    assert torch.equal(o, out.detach())
    ref = fa._flash_bwd_plain(q.detach().float(), k.detach().float(),
                              v.detach().float(), o.float(), lse,
                              up.float(), True, None, 0.1, pair)
    for t, r in zip((q, k, v), ref):
        _close(t.grad, r, tol=2e-2, floor=1e-3)
    again = fa.flash_attention(q, k, v, causal=True, dropout_p=0.1)
    assert not torch.equal(again, out)


def _window_case(gen, lengths, w, h, hkv, d, quantized, bs=None, cap=2048,
                 dtype=torch.bfloat16):
    """q [B, W, H, D] (``dtype``) over a dense cache [B, cap, Hkv, D], or
    (``bs``) a shuffled pool whose tables cover min(len + W, cap)
    positions per slot and end in null-block tails."""
    b = len(lengths)
    q = _rand((b, w, h, d), gen, dtype)
    tables = None
    if bs is None:
        k = _rand((b, cap, hkv, d), gen)
        v = _rand((b, cap, hkv, d), gen)
    else:
        need = [-(-min(n + w, cap) // bs) for n in lengths]
        nb = 1 + sum(need)
        k = _rand((nb, bs, hkv, d), gen)
        v = _rand((nb, bs, hkv, d), gen)
        perm = 1 + torch.randperm(nb - 1,
                                  generator=torch.Generator().manual_seed(b))
        tables = torch.zeros((b, cap // bs), dtype=torch.int32)
        used = 0
        for i, n in enumerate(need):
            tables[i, :n] = perm[used:used + n]
            used += n
        tables = tables.cuda()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    ks = vs = None
    if quantized:
        (k, ks), (v, vs) = _int8(k), _int8(v)
    return q, k, v, tables, lens, ks, vs


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("bs", [None, 128, 16], ids=["dense", "bs128",
                                                     "bs16"])
@pytest.mark.parametrize("lengths,w,h,hkv,d", [
    ([0, 1, 700, 2043], 5, 16, 16, 128),           # the verify window
    ([0, 64, 1000, 1536], 512, 16, 16, 128),       # a prefill chunk
    ([0, 300, 2043], 5, 16, 1, 128),               # G = 16
    ([2, 1200], 1, 16, 1, 128),
    ([0, 700, 2043], 5, 12, 12, 64)])              # the draft's heads
def test_window_kernels_match_plain(gen, lengths, w, h, hkv, d, bs,
                                    quantized):
    """Rows 8a, 8b, 9a, 9b: every output row within 1e-2 of its own
    scale; one launch per call."""
    q, k, v, tables, lens, ks, vs = _window_case(gen, lengths, w, h, hkv, d,
                                                 quantized, bs)
    # the plain version in f32 over the values the kernels attend: int8
    # codes dequantized to bf16 first, as the kernels and the JAX
    # composite dequantize them to q's dtype
    kp, vp = (k, v) if not quantized else (
        qm.dequantize_kv(k, ks, torch.bfloat16),
        qm.dequantize_kv(v, vs, torch.bfloat16))
    kp, vp = kp.float(), vp.float()
    if bs is None:
        kern = da.WINDOW_ATTENTION_Q if quantized else da.WINDOW_ATTENTION
        n = kern.launches
        o = da.decode_attention_window(q, k, v, lens, ks, vs)
        ref = da._window_plain(q.float(), kp, vp, lens)
    else:
        kern = da.PAGED_WINDOW_ATTENTION_Q if quantized else \
            da.PAGED_WINDOW_ATTENTION
        n = kern.launches
        o = da.paged_decode_attention_window(q, k, v, tables, lens, ks, vs)
        ref = da._paged_window_plain(q.float(), kp, vp, tables, lens)
    assert kern.launches == n + 1
    _close(o, ref)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("lengths,w,h,hkv,d,bs,cap", [
    ([0, 300, 2043], 5, 16, 4, 128, None, 2048),   # W G = 20: one tile
    ([0, 300, 2043], 5, 16, 4, 128, 16, 2048),
    ([0, 37, 1200], 64, 16, 1, 128, None, 2048),   # W G = 1024, G = 16
    ([0, 37, 1200], 64, 16, 1, 128, 128, 2048),
    ([1536, 1536], 512, 16, 16, 128, None, 2048),  # the chunk at S - W
    ([0, 1536], 512, 16, 16, 128, 128, 2048),
    ([0, 37, 500, 1472], 64, 16, 4, 128, 48, 1536)])  # blocks of 48
def test_window_chunk_kernels_on_the_wgmma_mainloop(gen, lengths, w, h, hkv,
                                                    d, bs, cap, quantized):
    """The window kernels' chunk regime (W G > 16 rows a kv head) on the
    shared wgmma mainloop: every row within 1e-2 of its own scale, two
    calls bitwise equal, one launch per call."""
    q, k, v, tables, lens, ks, vs = _window_case(gen, lengths, w, h, hkv, d,
                                                 quantized, bs, cap)
    kp, vp = (k, v) if not quantized else (
        qm.dequantize_kv(k, ks, torch.bfloat16),
        qm.dequantize_kv(v, vs, torch.bfloat16))
    kp, vp = kp.float(), vp.float()
    if bs is None:
        kern = da.WINDOW_ATTENTION_Q if quantized else da.WINDOW_ATTENTION
        n = kern.launches
        o = da.decode_attention_window(q, k, v, lens, ks, vs)
        again = da.decode_attention_window(q, k, v, lens, ks, vs)
        ref = da._window_plain(q.float(), kp, vp, lens)
    else:
        kern = da.PAGED_WINDOW_ATTENTION_Q if quantized else \
            da.PAGED_WINDOW_ATTENTION
        n = kern.launches
        o = da.paged_decode_attention_window(q, k, v, tables, lens, ks, vs)
        again = da.paged_decode_attention_window(q, k, v, tables, lens, ks,
                                                 vs)
        ref = da._paged_window_plain(q.float(), kp, vp, tables, lens)
    assert kern.launches == n + 2
    assert torch.equal(o, again)
    _close(o, ref)


@pytest.mark.parametrize("layout", [None, 128, 16, 48],
                         ids=["dense", "bs128", "bs16", "bs48"])
@pytest.mark.parametrize("lengths,w,h,hkv,d,dtype", [
    ([0, 1, 63, 64, 65, 700, 1500, 2043], 5, 16, 16, 128, torch.bfloat16),
    ([2043], 5, 16, 16, 128, torch.bfloat16),   # B=1: a cluster of CTAs
    ([64], 5, 16, 16, 128, torch.bfloat16),
    ([0, 1000, 2047], 1, 16, 1, 128, torch.bfloat16),  # G = 16, W = 1
    ([0, 1, 700, 2043], 5, 12, 12, 64, torch.float16)],  # D=64, fp16 q
    ids=["b8", "b1_long", "b1_tile", "g16_w1", "d64_fp16"])
def test_window_int8_verify_on_the_code_ring(gen, lengths, w, h, hkv, d,
                                             dtype, layout):
    """Rows 8b and 9b in the verify regime (W G <= 16): lengths around a
    64-key tile and at S - W, B = 8 and 1, every row within 1e-2 of the
    plain version over the codes dequantized to q's dtype, two calls
    bitwise equal, one launch each.  Blocks of 48 run on a 1536-position
    cap.  Paged tables carry a poisoned block id (far past the pool) in
    every entry past the live ones: a kernel reading one faults."""
    cap = 1536 if layout == 48 else 2048
    lengths = [min(n, cap - w) for n in lengths]
    q, k, v, tables, lens, ks, vs = _window_case(gen, lengths, w, h, hkv, d,
                                                 True, layout, cap, dtype)
    kp = qm.dequantize_kv(k, ks, dtype).float()
    vp = qm.dequantize_kv(v, vs, dtype).float()
    if layout is None:
        kern = da.WINDOW_ATTENTION_Q
        n = kern.launches
        o = da.decode_attention_window(q, k, v, lens, ks, vs)
        again = da.decode_attention_window(q, k, v, lens, ks, vs)
        ref = da._window_plain(q.float(), kp, vp, lens)
    else:
        live = torch.tensor([-(-min(x + w, cap) // layout) for x in lengths],
                            device="cuda")
        past = torch.arange(tables.shape[1], device="cuda")[None] >= live[:, None]
        poisoned = torch.where(past, torch.full_like(tables, 1 << 24), tables)
        kern = da.PAGED_WINDOW_ATTENTION_Q
        n = kern.launches
        o = da.paged_decode_attention_window(q, k, v, poisoned, lens, ks, vs)
        again = da.paged_decode_attention_window(q, k, v, poisoned, lens, ks,
                                                 vs)
        ref = da._paged_window_plain(q.float(), kp, vp, tables, lens)
    torch.cuda.synchronize()
    assert kern.launches == n + 2
    assert torch.equal(o, again)
    _close(o, ref)


@pytest.mark.parametrize("layout", [None, 128, 64, 16],
                         ids=["dense", "bs128", "bs64", "bs16"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("lengths,w,h,hkv,d", [
    ([0, 1, 15, 16, 63, 64, 128, 2043], 5, 16, 16, 128),  # B=8
    ([2043], 5, 16, 16, 128),          # B=1: a cluster of CTAs a kv head
    ([0, 1, 127, 2047], 1, 16, 1, 128),  # G = 16, W = 1, cap - W
    ([129], 1, 16, 1, 128),            # B=1, G = 16
    ([0, 1, 64, 700, 2043], 5, 12, 12, 64),  # D = 64
    ([0, 16, 2047], 1, 16, 1, 64)],    # D = 64, G = 16
    ids=["b8", "b1", "g16_w1", "b1_g16", "d64", "d64_g16"])
def test_window_bf16_verify_on_the_ring(gen, lengths, w, h, hkv, d, dtype,
                                        layout):
    """Rows 8a and 9a in the verify regime (W G <= 16) on the K/V ring:
    lengths 0, 1, at and around block edges and at capacity - W, B = 8
    and 1, G = 1 and 16, D = 128 and 64, bf16 and fp16; every row within
    1e-2 of the plain version in f32, two calls bitwise equal, one launch
    each.  Paged tables carry a poisoned block id (far past the pool) in
    every entry past the live ones: a kernel reading one faults."""
    cap = 2048
    b = len(lengths)
    q = _rand((b, w, h, d), gen, dtype)
    if layout is None:
        k, v = _rand((b, cap, hkv, d), gen, dtype), _rand((b, cap, hkv, d), gen,
                                                          dtype)
        kern = da.WINDOW_ATTENTION
    else:
        need = [-(-min(n + w, cap) // layout) for n in lengths]
        nb = 1 + sum(need)
        k, v = (_rand((nb, layout, hkv, d), gen, dtype) for _ in range(2))
        perm = 1 + torch.randperm(nb - 1, generator=torch.Generator().manual_seed(b))
        tables = torch.full((b, cap // layout), 1 << 24, dtype=torch.int32)
        used = 0
        for i, n in enumerate(need):
            tables[i, :n] = perm[used:used + n]
            used += n
        tables = tables.cuda()
        kern = da.PAGED_WINDOW_ATTENTION
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    n = kern.launches
    if layout is None:
        o = da.decode_attention_window(q, k, v, lens)
        again = da.decode_attention_window(q, k, v, lens)
        ref = da._window_plain(q.float(), k.float(), v.float(), lens)
    else:
        o = da.paged_decode_attention_window(q, k, v, tables, lens)
        again = da.paged_decode_attention_window(q, k, v, tables, lens)
        live = torch.where(tables < nb, tables, torch.zeros_like(tables))
        ref = da._paged_window_plain(q.float(), k.float(), v.float(), live,
                                     lens)
    torch.cuda.synchronize()
    assert kern.launches == n + 2
    assert torch.equal(o, again)
    _close(o, ref)


@pytest.mark.parametrize("case", ["d96", "group", "bs8", "tables64"])
def test_window_paths_raise_instead_of_falling_back(gen, case):
    """D=96, H % Hkv != 0, a block size of 8 and int64 tables raise on
    the card before any launch."""
    d = 96 if case == "d96" else 64
    q = _rand((2, 3, 8, d), gen)
    cache = _rand((2, 64, 3 if case == "group" else 4, d), gen)
    pool = _rand((5, 8 if case == "bs8" else 16, 4, d), gen)
    tables = torch.ones((2, 4), dtype=torch.int64 if case == "tables64"
                        else torch.int32, device="cuda")
    lens = torch.full((2,), 5, dtype=torch.int32, device="cuda")
    kernels = (da.WINDOW_ATTENTION, da.PAGED_WINDOW_ATTENTION)
    counts = [kern.launches for kern in kernels]
    with pytest.raises((ValueError, TypeError)):
        if case in ("bs8", "tables64"):
            da.paged_decode_attention_window(q, pool, pool, tables, lens)
        else:
            da.decode_attention_window(q, cache, cache, lens)
    assert counts == [kern.launches for kern in kernels]


def _tiny_engine(**kw):
    from paddle_tpu_torch.inference import InferenceEngine
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                    num_heads=4, max_seq_len=256)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16)
    if kw.pop("self_draft", False):
        kw["draft_model"] = model
    return InferenceEngine(model, batch_slots=4, device="cuda", **kw)


@pytest.mark.parametrize("kw", [
    dict(prefill_chunk=32), dict(prefill_chunk=32, kv_layout="paged",
                                 kv_block_size=16, kv_dtype="int8"),
    dict(spec_k=3, self_draft=True), dict(spec_k=2, self_draft=True,
                                          kv_layout="paged",
                                          kv_block_size=16)],
    ids=["chunked", "chunked-paged-int8", "spec", "spec-paged"])
def test_engines_sync_once_per_tick_on_the_card(gen, kw, monkeypatch):
    """Chunked and speculative engines on the card: every device-to-host
    read is a decode step's or spec tick's, or a graduating chunk
    tick's, and the window kernels ran."""
    eng = _tiny_engine(**kw)
    rng = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, 512, (n,), generator=rng).numpy()
               for n in (20, 100, 70, 5, 150)]
    reads = {"n": 0}
    for name in ("cpu", "item", "tolist", "numpy"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **k):
            reads["n"] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    launches = sum(kern.launches for kern in (
        da.WINDOW_ATTENTION, da.WINDOW_ATTENTION_Q,
        da.PAGED_WINDOW_ATTENTION, da.PAGED_WINDOW_ATTENTION_Q))
    for p in prompts:
        eng.add_request(p, max_new_tokens=12)
    out = eng.run()
    monkeypatch.undo()
    st = eng.stats()
    assert all(len(t) == 12 for t in out.values())
    assert reads["n"] == st["host_syncs"] == \
        st["decode_steps"] + st["prefill_host_syncs"]
    if "prefill_chunk" in kw:
        assert st["prefill_host_syncs"] == st["chunk_graduation_ticks"]
    else:
        assert st["spec_ticks"] == st["decode_steps"]
    assert sum(kern.launches for kern in (
        da.WINDOW_ATTENTION, da.WINDOW_ATTENTION_Q,
        da.PAGED_WINDOW_ATTENTION, da.PAGED_WINDOW_ATTENTION_Q)) > launches


def test_deadline_and_drain_on_the_card(gen, monkeypatch):
    """A 2-layer engine on the card after ``warmup()``: a queued request
    with ``deadline_s=0.0`` comes back empty, a live one whose deadline
    passed with its partial tokens, ``drain()`` finishes the in-flight
    slots and returns the queue in FIFO order, and every device-to-host
    read is a decode step's or an admission's."""
    import time
    eng = _tiny_engine().warmup()
    rng = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, 512, (n,), generator=rng).numpy()
               for n in (20, 100, 70, 5, 150, 33, 64, 90)]
    reads = {"n": 0}
    for name in ("cpu", "item", "tolist", "numpy"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **k):
            reads["n"] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    live = eng.add_request(prompts[0], max_new_tokens=200, deadline_s=60.0)
    expired = eng.add_request(prompts[1], max_new_tokens=8, deadline_s=0.0)
    busy = [eng.add_request(p, max_new_tokens=12) for p in prompts[2:5]]
    for _ in range(3):
        eng.step_or_raise()
    eng._slots[0].deadline = time.perf_counter()        # already passed
    eng.step_or_raise()
    queued = [eng.add_request(p, max_new_tokens=12) for p in prompts[5:]]
    leftover = eng.drain()
    monkeypatch.undo()
    st = eng.stats()
    rec_live, rec_exp = eng.request_stats[live], eng.request_stats[expired]
    assert rec_live["timed_out"] and 0 < rec_live["tokens"] < 200
    assert rec_exp["timed_out"] and rec_exp["tokens"] == 0
    assert rec_exp["ttft_ms"] is None
    assert st["deadline_retirements"] == 2
    assert all(len(eng.results[r]) == 12 for r in busy)
    assert [r.rid for r in leftover] == queued
    assert reads["n"] == st["host_syncs"] == \
        st["decode_steps"] + st["prefill_host_syncs"]
    assert st["decode_host_syncs"] == st["decode_steps"] > 0


# ---- int8 matmul (exact) and the decode megakernel -----------------------------

QMM_OUT = [torch.float32, torch.bfloat16, torch.float16]
QMM_OUT_IDS = ["f32", "bf16", "fp16"]


def _qmm_operands(gen, m, k, n):
    x = _rand((m, k), gen)
    w = (torch.randn((k, n), generator=gen, device="cuda") * 0.05
         ).bfloat16()
    qx, sx = qm.quantize_channel(x, axis=1)
    qw_t, sw_t = qm.quantize_channel(w.t(), axis=1)
    return x, w, qx, qw_t.contiguous(), sx, sw_t.reshape(1, n)


@pytest.mark.parametrize("out", QMM_OUT, ids=QMM_OUT_IDS)
@pytest.mark.parametrize("m", [1, 8, 16, 17, 33, 64, 65, 129, 512, 1000])
def test_qmm_kernel_equals_plain(gen, m, out):
    """Exact int32 sums and the same f32 rescale: bitwise equal, in both
    regimes (M <= 16 split over every SM, wgmma tiles of 64 or 128 rows
    above) and across ragged row tiles."""
    x, w, qx, qw_t, sx, sw = _qmm_operands(gen, m, 256, 384)
    got = qm._qmm_cuda(qx, qw_t, sx, sw, out)
    assert torch.equal(got, qm._qmm_plain(qx, qw_t.t(), sx, sw, out))
    # the public op on the card equals the CPU's from the same inputs:
    # the same codes and scales (true division on both), exact sums
    assert torch.equal(qm.quantized_matmul(x, w, out_dtype=out).cpu(),
                       qm.quantized_matmul(x.cpu(), w.cpu(), out_dtype=out))


@pytest.mark.parametrize("out", QMM_OUT, ids=QMM_OUT_IDS)
@pytest.mark.parametrize("m", [8, 512])
@pytest.mark.parametrize("k,n", [(128, 128), (8192, 2048), (256, 384)])
def test_qmm_kernel_shapes_equal_plain(gen, k, n, m, out):
    """Edge widths (one strip pair, the N = 384 edge) and the long down
    product, whose M = 512 plan splits K: bitwise the plain version."""
    _, _, qx, qw_t, sx, sw = _qmm_operands(gen, m, k, n)
    plan = qm._qmm_plan(m, n, k, qm._sm_count(qx.device))
    if (m, k) == (512, 8192):
        assert plan["splits"] > 1
    assert torch.equal(qm._qmm_cuda(qx, qw_t, sx, sw, out),
                       qm._qmm_plain(qx, qw_t.t(), sx, sw, out))


@pytest.mark.parametrize("bn,splits", [(256, 1), (256, 2), (128, 2),
                                       (128, 1)])
@pytest.mark.parametrize("m", [17, 100, 300])
def test_qmm_kernel_forced_plans_equal_plain(gen, monkeypatch, m, bn, splits):
    """Every tile width over N = 384 (a 256-wide tile leaves a 128-wide
    edge, filled by TMA with zeros and not written) with and without a K
    split, through plans the wrapper would not choose here."""
    plan = qm._qmm_plan
    # the wrapper also passes the tuning table's overrides (None here)
    monkeypatch.setattr(qm, "_qmm_plan", lambda m_, n_, k_, sms, *tuned: plan(
        m_, n_, k_, sms, bn, splits))
    _, _, qx, qw_t, sx, sw = _qmm_operands(gen, m, 256, 384)
    got = qm._qmm_cuda(qx, qw_t, sx, sw, torch.float32)
    assert torch.equal(got, qm._qmm_plain(qx, qw_t.t(), sx, sw,
                                          torch.float32))


@pytest.mark.parametrize("m,k,n", [(8, 8192, 2048), (16, 2048, 6144),
                                   (512, 8192, 2048), (4096, 2048, 2048)])
def test_qmm_kernel_repeats_bitwise(gen, m, k, n):
    """Two calls give the same bits (the split sums are integer, and the
    counters every launch leaves zeroed let the next one reduce right)."""
    _, _, qx, qw_t, sx, sw = _qmm_operands(gen, m, k, n)
    a = qm._qmm_cuda(qx, qw_t, sx, sw, torch.bfloat16)
    b = qm._qmm_cuda(qx, qw_t, sx, sw, torch.bfloat16)
    assert torch.equal(a, b)


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "fresh"])
@pytest.mark.parametrize("m,k,n", [(8, 8192, 2048), (512, 8192, 2048)])
def test_qmm_kernel_graph_replays_equal_eager(gen, m, k, n, warm):
    """A captured call (decode regime, and the prefill split) replays three
    times equal to eager.  Captured on the stream of the eager call
    (warm), it shares that stream's arrival counters, which every launch
    leaves at zero; captured on a fresh stream, the graph zeroes counters
    of its own."""
    _, _, qx, qw_t, sx, sw = _qmm_operands(gen, m, k, n)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        eager = qm._qmm_cuda(qx, qw_t, sx, sw, torch.bfloat16)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream if warm else None):
            out = qm._qmm_cuda(qx, qw_t, sx, sw, torch.bfloat16)
    torch.cuda.current_stream().wait_stream(stream)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    with torch.cuda.stream(stream):
        again = qm._qmm_cuda(qx, qw_t, sx, sw, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(again, eager)


def test_fake_quant_matmul_backward_on_the_card(gen):
    x = torch.randn((4, 9, 128), generator=gen, device="cuda")
    w = torch.randn((128, 256), generator=gen, device="cuda") * 0.1
    g = torch.randn((4, 9, 256), generator=gen, device="cuda")
    grads = []
    for dev in ("cuda", "cpu"):
        xs, ws = (a.detach().to(dev, copy=True).requires_grad_()
                  for a in (x, w))
        (qm.fake_quant_matmul(xs, ws) * g.to(dev)).sum().backward()
        grads.append((xs.grad.cpu(), ws.grad.cpu()))
    for a, b in zip(*grads):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def _mega_block(gen, h, heads, hkv, f):
    from paddle_tpu_torch.models import GPTConfig
    from paddle_tpu_torch.models.gpt import GPTBlock
    cfg = GPTConfig(hidden_size=h, num_layers=4, num_heads=heads,
                    num_kv_heads=hkv, ffn_hidden_size=f)
    blk = GPTBlock(cfg, device="cuda", dtype=torch.bfloat16, generator=gen)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if p.dim() == 1:
                p.copy_((1.0 if name.endswith("weight") else 0.0) + 0.05
                        * torch.randn(p.shape, generator=gen, device="cuda"))
    return blk


def _mega_case(gen, blk, lengths, quantized, bs=None, cap=256):
    cfg = blk.attn.cfg
    hkv, d = cfg.num_kv_heads, cfg.head_dim
    b = len(lengths)
    x = _rand((b, cfg.hidden_size), gen)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    tables = None
    if bs is None:
        k, v = _rand((b, cap, hkv, d), gen), _rand((b, cap, hkv, d), gen)
    else:
        mb = cap // bs
        nb = 1 + b * mb
        k, v = _rand((nb, bs, hkv, d), gen), _rand((nb, bs, hkv, d), gen)
        perm = 1 + torch.randperm(nb - 1, generator=gen, device="cuda")
        tables = torch.zeros((b, mb), dtype=torch.int32, device="cuda")
        for i, n in enumerate(lengths):
            need = -(-n // bs)
            tables[i, :need] = perm[i * mb:i * mb + need].int()
    ks = vs = None
    if quantized:
        (k, ks), (v, vs) = _int8(k), _int8(v)
    return x, k, v, tables, lens, ks, vs


def _mega_run(blk, case, plain=False):
    mk = importlib.import_module("paddle_tpu_torch.ops.decode_megakernel")
    x, k, v, tables, lens, ks, vs = case
    w = blk._megakernel_weights()
    if plain:
        return mk._mega_plain(x.float(), w, k, v, lens, ks, vs, tables)
    if tables is None:
        return mk.decode_layer_step(x, w, k, v, lens, ks, vs)
    return mk.decode_layer_step_paged(x, w, k, v, tables, lens, ks, vs)


@pytest.mark.parametrize("b", [1, 3, 8, 16])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("bs", [None, 128, 16], ids=["dense", "bs128",
                                                     "bs16"])
@pytest.mark.parametrize("heads,hkv,h", [(2, 2, 256), (4, 1, 256),
                                         (16, 1, 1024), (4, 4, 256)],
                         ids=["mha128", "g4", "g16-d64", "mha-d64"])
def test_megakernel_matches_plain(gen, heads, hkv, h, bs, quantized, b):
    """Every output row (x_out per slot, k_new/v_new per (slot, kv
    head)) within 1e-2 of its own scale of ``_mega_plain`` at B = 1, 3,
    8 and 16: lengths 0, 1, a block edge and one past it, cap - 1 and cap
    (dense); a second call bitwise equal."""
    blk = _mega_block(gen, h, heads, hkv, 2 * h)
    lengths = ([0, 1, 127, 128, 255, 256 if bs is None else 200, 16, 129,
                64, 2, 250, 31, 100, 17, 254, 193] * 2)[:b]
    if b == 1:
        lengths = [255]
    case = _mega_case(gen, blk, lengths, quantized, bs)
    got = _mega_run(blk, case)
    again = _mega_run(blk, case)
    ref = _mega_run(blk, case, plain=True)
    for g, a, r in zip(got, again, ref):
        assert torch.isfinite(g).all()
        assert torch.equal(g, a)
        _close(g, r)


@pytest.mark.parametrize("bs,quantized", [(None, False), (16, True)],
                         ids=["dense", "paged-int8"])
def test_megakernel_replays_from_a_cuda_graph(gen, bs, quantized):
    """One layer step captured in a CUDA graph and replayed equals an
    eager call bitwise."""
    blk = _mega_block(gen, 256, 2, 2, 512)
    case = _mega_case(gen, blk, [3, 90, 255, 0, 17], quantized, bs)
    eager = _mega_run(blk, case)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _mega_run(blk, case)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = _mega_run(blk, case)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    for e, r in zip(eager, replayed):
        assert torch.equal(e, r)


def test_megakernel_is_one_launch_and_reads_only(gen):
    mk = importlib.import_module("paddle_tpu_torch.ops.decode_megakernel")
    blk = _mega_block(gen, 256, 2, 2, 512)
    case = _mega_case(gen, blk, [3, 90, 255, 0], True, bs=16)
    before = [t.clone() for t in case[1:3] + case[5:7]]
    n = mk.PAGED_DECODE_MEGAKERNEL_Q.launches
    _mega_run(blk, case)
    torch.cuda.synchronize()
    assert mk.PAGED_DECODE_MEGAKERNEL_Q.launches == n + 1
    assert all(torch.equal(a, b)
               for a, b in zip(before, case[1:3] + case[5:7]))


@pytest.mark.parametrize("case", ["fp8", "d96", "strided", "slots17",
                                  "f32"])
def test_megakernel_raises_instead_of_falling_back(gen, case):
    mk = importlib.import_module("paddle_tpu_torch.ops.decode_megakernel")
    blk = _mega_block(gen, 256, 2, 2, 512)
    x, k, v, tables, lens, ks, vs = _mega_case(gen, blk, [5, 9], False)
    w = list(blk._megakernel_weights())
    if case == "fp8":
        # fp8 compute, and an e4m3 cache, take the composed step (as in the
        # JAX package) on the e4m3 kernels: no megakernel launch
        mega = (mk.DECODE_MEGAKERNEL.launches, mk.DECODE_MEGAKERNEL_Q.launches)
        n_mm, n_da = qm.QUANTIZED_MATMUL_F8.launches, \
            da.DECODE_ATTENTION_F8.launches
        mk.decode_layer_step(x, w, k.clone(), v.clone(), lens, quantize="fp8")
        (k8, ks8), (v8, vs8) = qm.quantize_kv(k, "fp8"), qm.quantize_kv(v, "fp8")
        out = mk.decode_layer_step(x, w, k8, v8, lens, ks8, vs8)
        torch.cuda.synchronize()
        assert (mk.DECODE_MEGAKERNEL.launches,
                mk.DECODE_MEGAKERNEL_Q.launches) == mega
        assert qm.QUANTIZED_MATMUL_F8.launches == n_mm + 4
        assert da.DECODE_ATTENTION_F8.launches == n_da + 1
        assert all(torch.isfinite(t).all() for t in out)
        return
    if case == "d96":
        blk = _mega_block(gen, 384, 4, 4, 512)
        w = list(blk._megakernel_weights())
        x = _rand((2, 384), gen)
        k = v = _rand((2, 64, 4, 96), gen)
    elif case == "strided":
        w[2] = w[2].t().contiguous().t()
    elif case == "slots17":
        x = _rand((17, 256), gen)
        k = v = _rand((17, 64, 2, 128), gen)
        lens = torch.zeros(17, dtype=torch.int32, device="cuda")
    else:
        x = x.float()
    with pytest.raises((ValueError, TypeError)):
        mk.decode_layer_step(x, w, k, v, lens)


def test_quantize_routes_the_composite_on_the_card(gen):
    """int8 compute takes the composed route: four int8 matmul launches
    and the decode attention kernel, no megakernel launch."""
    mk = importlib.import_module("paddle_tpu_torch.ops.decode_megakernel")
    blk = _mega_block(gen, 256, 2, 2, 512)
    x, k, v, _, lens, _, _ = _mega_case(gen, blk, [5, 100], False)
    counts = [kern.launches for kern in (qm.QUANTIZED_MATMUL,
                                         mk.DECODE_MEGAKERNEL,
                                         da.DECODE_ATTENTION)]
    out = mk.decode_layer_step(x, blk._megakernel_weights(), k, v, lens,
                               quantize="int8")
    torch.cuda.synchronize()
    assert all(torch.isfinite(o).all() for o in out)
    assert [kern.launches for kern in (qm.QUANTIZED_MATMUL,
                                       mk.DECODE_MEGAKERNEL,
                                       da.DECODE_ATTENTION)] == \
        [counts[0] + 4, counts[1], counts[2] + 1]


@pytest.mark.parametrize("kw", [dict(), dict(kv_layout="paged",
                                             kv_block_size=16,
                                             kv_dtype="int8")],
                         ids=["dense", "paged-int8"])
def test_megakernel_engine_on_the_card(gen, kw):
    """A megakernel engine: one fused launch per layer per decode step,
    no decode attention launch, one host sync per decode step."""
    mk = importlib.import_module("paddle_tpu_torch.ops.decode_megakernel")
    eng = _tiny_engine(**kw)
    eng.model.enable_decode_megakernel()
    kern = mk.PAGED_DECODE_MEGAKERNEL_Q if kw else mk.DECODE_MEGAKERNEL
    n0, d0 = kern.launches, da.DECODE_ATTENTION.launches + \
        da.PAGED_DECODE_ATTENTION_Q.launches
    rng = torch.Generator().manual_seed(4)
    for n in (20, 100, 70, 5, 150):
        eng.add_request(torch.randint(0, 512, (n,), generator=rng).numpy(),
                        max_new_tokens=10)
    out = eng.run()
    st = eng.stats()
    assert all(len(t) == 10 for t in out.values())
    assert st["decode_megakernel"] and \
        st["decode_host_syncs"] == st["decode_steps"]
    assert kern.launches - n0 == 2 * st["decode_steps"]
    assert da.DECODE_ATTENTION.launches + \
        da.PAGED_DECODE_ATTENTION_Q.launches == d0


def _train_pair_model(gen, **strategy):
    """A 2-layer GPT (D = 128) on the card behind ``SpmdTrainer`` with
    AMP; ``strategy`` keys are set on its DistributedStrategy."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.core import random as prandom
    from paddle_tpu_torch.distributed import SpmdTrainer
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         GPTPretrainingCriterion)
    cfg = GPTConfig(vocab_size=1024, hidden_size=256, num_layers=2,
                    num_heads=2, max_seq_len=256, fused_ce=True)
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=prandom.seed(7, "cuda"))
    st = DistributedStrategy()
    st.amp = True
    for k, v in strategy.items():
        setattr(st, k, v)
    crit = GPTPretrainingCriterion()
    return model, SpmdTrainer(model, topt.Adam(learning_rate=1e-3),
                              lambda o, lab: crit(o, lab), strategy=st)


def _token_batch(gen, b=2, s=256, v=1024):
    ids = torch.randint(0, v, (b, s), generator=gen, device="cuda",
                        dtype=torch.int32)
    return ids, torch.roll(ids, -1, 1)


def test_fp16_train_step_runs_the_kernels_without_a_host_sync(gen):
    from paddle_tpu_torch.distributed import async_dispatch
    from paddle_tpu_torch.ops import KERNELS
    model, tr = _train_pair_model(
        gen, amp_configs={"use_bf16": False, "init_loss_scaling": 1024.0})
    batches = [_token_batch(gen) for _ in range(3)]
    torch.cuda.synchronize()
    for k in KERNELS.values():
        k.launches = 0
    async_dispatch.reset_host_sync_count()
    results = [tr.train_step(*b) for b in batches]
    assert async_dispatch.host_sync_count() == 0
    for src in ("flash_fwd.cu", "flash_bwd_dq.cu", "flash_bwd_dkv.cu"):
        assert KERNELS[src].launches == 2 * 3, src
    losses = [float(r) for r in results]
    assert all(torch.isfinite(torch.tensor(losses)))
    assert tr.amp_dtype == torch.float16 and tr.loss_scale == 1024.0
    assert tr.stats["skipped_steps"] == 0
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("heads,dtype,err", [
    (8, torch.bfloat16, ValueError),     # head dim 32
    (4, torch.float32, TypeError)],      # head dim 64 in f32
    ids=["d32", "f32"])
def test_gpt_raises_where_the_kernels_do_not_take_its_attention(
        gen, heads, dtype, err):
    """GPT calls the flash kernels itself, never the layer API's route,
    so a shape or dtype they do not take raises on the card instead of
    running the composite."""
    from paddle_tpu_torch.core import random as prandom
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn.functional import attention
    cfg = GPTConfig(vocab_size=128, hidden_size=256, num_layers=1,
                    num_heads=heads, max_seq_len=64)
    model = GPTForCausalLM(cfg, device="cuda", dtype=dtype,
                           generator=prandom.seed(7, "cuda"))
    ids = torch.randint(0, 128, (2, 64), generator=gen, device="cuda")
    before = attention.COMPOSITE.launches
    with pytest.raises(err, match="flash_attention kernel"):
        model(ids)
    assert attention.COMPOSITE.launches == before


def test_dots_recompute_gradients_equal_no_recompute_on_the_card(gen):
    ids, labels = _token_batch(gen)
    grads = []
    for strategy in ({}, {"recompute": True,
                          "recompute_configs": {"policy": "dots"}}):
        model, tr = _train_pair_model(gen, **strategy)
        tr.train_step(ids, labels)
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    assert model.gpt._recompute_policy == "dots"
    for n, g in grads[0].items():
        assert torch.equal(grads[1][n], g), n


def _capture_kernel_names(path):
    import json
    with open(path) as f:
        return {e["name"] for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and e.get("cat") == "kernel"}


@pytest.mark.parametrize("kw", [dict(), dict(kv_layout="paged",
                                             kv_block_size=16)],
                         ids=["dense", "paged"])
def test_capture_window_names_the_serving_kernels(gen, kw, tmp_path,
                                                  monkeypatch):
    """``PADDLE_TPU_PROFILE`` over decode ticks 2-5 of a small engine on
    the card, with an admission inside the window: the capture's Chrome
    trace holds the decode kernel of the layout and the flash forward
    by their device names, and telemetry keeps one host sync a step."""
    from paddle_tpu_torch.observability import spans
    monkeypatch.setenv("PADDLE_TPU_PROFILE", f"2:5:{tmp_path}")
    eng = _tiny_engine(**kw)
    assert eng._profile is not None
    rng = torch.Generator().manual_seed(5)
    for n, new in ((20, 3), (100, 12), (70, 12), (5, 12), (150, 12)):
        eng.add_request(torch.randint(0, 512, (n,), generator=rng).numpy(),
                        max_new_tokens=new)
    tr = spans.tracer()
    tr.clear()
    tr.start()
    try:
        out = eng.run()
    finally:
        tr.stop()
        tr.clear()
    st = eng.stats()
    assert len(out) == 5 and st["decode_host_syncs"] == st["decode_steps"]
    names = _capture_kernel_names(eng._profile.trace_path)
    paged = "true>" if kw else "false>"
    assert any("decode_kernel" in n and paged in n for n in names), names
    assert any("attn_fwd_kernel" in n for n in names), names


def test_capture_window_names_the_training_kernels(gen, tmp_path):
    """A capture window over train steps 1-2 of a 2-layer GPT on the
    card holds the flash forward and both backward kernels by name."""
    from paddle_tpu_torch.observability import ProfileWindow
    _, tr = _train_pair_model(gen)
    tr._profile = ProfileWindow(1, 3, log_dir=str(tmp_path))
    batch = _token_batch(gen)
    for _ in range(4):
        tr.train_step(*batch)
    torch.cuda.synchronize()
    assert tr._profile.done
    names = _capture_kernel_names(tr._profile.trace_path)
    for part in ("attn_fwd_kernel", "flash_bwd_dq_kernel",
                 "flash_bwd_dkv_kernel"):
        assert any(part in n for n in names), (part, names)


# ---- mixture of experts (no kernel of its own: index ops and bmm) --------
def _moe_pair(gen, e=8, h=64, f=128, cf=1.0):
    """A MoE layer on the CPU (random biases too) and its copy on the
    card."""
    import copy
    from paddle_tpu_torch.distributed.moe import MoELayer
    cpu = MoELayer(h, f, e, top_k=2, capacity_factor=cf, device="cpu")
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(torch.randn(p.shape, generator=gen,
                               device="cuda").cpu() * 0.05)
    return cpu, copy.deepcopy(cpu).cuda()


def test_moe_layer_on_the_card_equals_the_cpu(gen):
    """Same weights and input, f32: the card's output within 1e-4 of the
    CPU's largest |y| (cuBLAS against the CPU's products, summed in
    another order), the same expert load (routing is discrete), aux
    within 1e-6."""
    from paddle_tpu_torch.distributed import moe
    cpu, dev = _moe_pair(gen)
    x = torch.randn((4, 96, 64), generator=gen, device="cuda")
    y_c, aux_c, _, load_c = cpu._fn_dense(x.cpu())
    y_d, aux_d, _, load_d = dev._fn_dense(x)
    assert torch.equal(load_d.cpu(), load_c)
    assert load_c.sum() < 2 * 4 * 96                  # capacity drops
    err = (y_d.cpu() - y_c).abs().max().item()
    assert err <= 1e-4 * y_c.abs().max().item(), err
    assert abs(aux_d.item() - aux_c.item()) <= 1e-6
    assert moe.moe_capacity(96, 8, 2, 1.0) == 24


def test_moe_layer_makes_no_host_sync(gen):
    """Forward and backward run with CUDA's sync debug mode at 'error'
    (any synchronizing call raises) and leave the port's host-sync count
    where it was."""
    from paddle_tpu_torch.distributed import async_dispatch, moe
    _, dev = _moe_pair(gen)
    x = torch.randn((4, 96, 64), generator=gen, device="cuda",
                    requires_grad=True)
    n0 = async_dispatch.host_sync_count()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with moe.collect_aux_losses() as aux, \
                moe.collect_expert_stats() as stats:
            y = dev(x)
        (y.square().sum() + aux[0]).backward()
        folded = moe.fold_expert_stats(stats)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert async_dispatch.host_sync_count() == n0
    assert folded["assigned"] == 2 * 4 * 96 and folded["load"].is_cuda
    assert dev.gate.grad.abs().max().item() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_layer_graph_replays_equal_eager(gen, dtype):
    """One MoE forward captured in a CUDA graph (fixed shapes, no host
    read) replays on a new input equal to the eager forward on it."""
    _, dev = _moe_pair(gen)
    dev = dev.to(dtype)
    static = torch.randn((4, 96, 64), generator=gen, device="cuda").to(dtype)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.no_grad(), torch.cuda.stream(side):
        for _ in range(2):
            dev(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad(), torch.cuda.graph(graph):
        out = dev(static)
    fresh = torch.randn((4, 96, 64), generator=gen, device="cuda").to(dtype)
    static.copy_(fresh)
    graph.replay()
    with torch.no_grad():
        want = dev(fresh)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


# ---- the e4m3 kernels: rows 5f, 7f, 8bf, 9bf, 10f --------------------------

def _f8(x):
    """bf16 values -> e4m3 codes and f32 scales (``quantize_kv(x,
    'fp8')``)."""
    return qm.quantize_kv(x, "fp8")


def _f8_window_case(gen, lengths, w, h, hkv, d, bs=None, cap=2048):
    """``_window_case``'s bf16 caches (or pools) turned into e4m3 codes."""
    q, k, v, tables, lens, _, _ = _window_case(gen, lengths, w, h, hkv, d,
                                               False, bs, cap)
    (k, ks), (v, vs) = _f8(k), _f8(v)
    return q, k, v, tables, lens, ks, vs


@pytest.mark.parametrize("h,hkv,d", [(16, 16, 128), (16, 4, 128), (8, 8, 64),
                                     (16, 1, 128)])
def test_decode_f8_kernel_matches_plain(gen, h, hkv, d):
    """Row 5f: e4m3 codes widened in the kernel, each scale applied to the
    f32 dot and to p; the plain version fed the same codes in f32."""
    lengths = [0, 1, 63, 64, 500, 1024]
    q = _rand((len(lengths), h, d), gen)
    kc, ks = _f8(_rand((len(lengths), 1024, hkv, d), gen))
    vc, vs = _f8(_rand((len(lengths), 1024, hkv, d), gen))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    n, n8 = da.DECODE_ATTENTION_F8.launches, da.DECODE_ATTENTION_Q.launches
    o = da.decode_attention(q, kc, vc, lens, ks, vs)
    assert da.DECODE_ATTENTION_F8.launches == n + 1
    assert da.DECODE_ATTENTION_Q.launches == n8
    _close(o, da._decode_plain(q.float(), kc, vc, lens, ks, vs))
    assert o[0].abs().max().item() == 0.0


@pytest.mark.parametrize("bs,h,hkv,d", [(128, 16, 16, 128), (16, 16, 4, 128),
                                        (32, 8, 8, 64), (128, 16, 1, 128)])
def test_paged_f8_kernel_matches_plain(gen, bs, h, hkv, d):
    """Row 7f: shuffled blocks, a length of one, an exact block multiple,
    a ragged tail and an inactive slot over e4m3 pools."""
    lengths = [1, 4 * bs, 3 * bs + 5, 0]
    q, k, v, tables, lens, _ = _paged_case(gen, lengths, 40, bs, h, hkv, d,
                                           False)
    (k, ks), (v, vs) = _f8(k), _f8(v)
    n = da.PAGED_DECODE_ATTENTION_F8.launches
    o = da.paged_decode_attention(q, k, v, tables, lens, ks, vs)
    assert da.PAGED_DECODE_ATTENTION_F8.launches == n + 1
    _close(o, da._paged_plain(q.float(), k, v, tables, lens, ks, vs))


@pytest.mark.parametrize("bs", [None, 128, 16, 48], ids=["dense", "bs128",
                                                         "bs16", "bs48"])
@pytest.mark.parametrize("lengths,w,h,hkv,d", [
    ([0, 1, 63, 64, 65, 700, 1400, 1531], 5, 16, 16, 128),  # the verify
    ([2043 - 512], 5, 16, 16, 128),               # B=1: a cluster of CTAs
    ([0, 300, 1531], 5, 16, 1, 128),              # G = 16
    ([0, 64, 1000], 512, 16, 16, 128),            # a prefill chunk
    ([0, 37, 1200], 64, 16, 1, 128),              # W G = 1024
    ([0, 700, 1531], 5, 12, 12, 64)])             # the draft's heads
def test_window_f8_kernels_match_plain(gen, lengths, w, h, hkv, d, bs):
    """Rows 8bf and 9bf in both regimes: every row within 1e-2 of the
    plain version over the codes dequantized to q's dtype (as the
    kernels and the JAX composite dequantize them), two calls bitwise
    equal, one launch each, no int8 launch (cap 1536, so blocks of 48
    tile it)."""
    cap = 1536
    q, k, v, tables, lens, ks, vs = _f8_window_case(gen, lengths, w, h, hkv,
                                                    d, bs, cap)
    kp = qm.dequantize_kv(k, ks, torch.bfloat16).float()
    vp = qm.dequantize_kv(v, vs, torch.bfloat16).float()
    q8 = (da.WINDOW_ATTENTION_Q.launches, da.PAGED_WINDOW_ATTENTION_Q.launches)
    if bs is None:
        kern = da.WINDOW_ATTENTION_F8
        n = kern.launches
        o = da.decode_attention_window(q, k, v, lens, ks, vs)
        again = da.decode_attention_window(q, k, v, lens, ks, vs)
        ref = da._window_plain(q.float(), kp, vp, lens)
    else:
        kern = da.PAGED_WINDOW_ATTENTION_F8
        n = kern.launches
        o = da.paged_decode_attention_window(q, k, v, tables, lens, ks, vs)
        again = da.paged_decode_attention_window(q, k, v, tables, lens, ks,
                                                 vs)
        ref = da._paged_window_plain(q.float(), kp, vp, tables, lens)
    torch.cuda.synchronize()
    assert kern.launches == n + 2
    assert q8 == (da.WINDOW_ATTENTION_Q.launches,
                  da.PAGED_WINDOW_ATTENTION_Q.launches)
    assert torch.equal(o, again)
    _close(o, ref)


@pytest.mark.parametrize("case", ["mixed", "d96", "layout", "group"])
def test_f8_attention_paths_raise_instead_of_falling_back(gen, case):
    """e4m3 K with int8 V, D=96, blocks of 8 and H % Hkv != 0 raise on the
    card before any launch, in all four entry points."""
    b, h, hkv, d, bs = 2, 8, 4, 64, 16
    if case == "d96":
        d = 96
    elif case == "layout":
        bs = 8
    elif case == "group":
        hkv = 3
    q = _rand((b, h, d), gen)
    k, ks = _f8(_rand((6, bs, hkv, d), gen))
    v = k.view(torch.int8) if case == "mixed" else k
    tables = torch.ones((b, 2), dtype=torch.int32, device="cuda")
    lens = torch.full((b,), 5, dtype=torch.int32, device="cuda")
    kerns = (da.DECODE_ATTENTION_F8, da.PAGED_DECODE_ATTENTION_F8,
             da.WINDOW_ATTENTION_F8, da.PAGED_WINDOW_ATTENTION_F8)
    counts = [kern.launches for kern in kerns]
    with pytest.raises((ValueError, TypeError)):
        da.paged_decode_attention(q, k, v, tables, lens, ks, ks)
    with pytest.raises((ValueError, TypeError)):
        da.paged_decode_attention_window(q[:, None], k, v, tables, lens, ks,
                                         ks)
    if case != "layout":
        dk = k.reshape(b, -1, hkv, d)
        dv = v.reshape(b, -1, hkv, d)
        ds = ks.reshape(b, -1, hkv)
        with pytest.raises((ValueError, TypeError)):
            da.decode_attention(q, dk, dv, lens, ds, ds)
        with pytest.raises((ValueError, TypeError)):
            da.decode_attention_window(q[:, None], dk, dv, lens, ds, ds)
    assert counts == [kern.launches for kern in kerns]


def _qmm_f8_operands(gen, m, k, n):
    x = _rand((m, k), gen)
    w = (torch.randn((k, n), generator=gen, device="cuda") * 0.05
         ).bfloat16()
    qx, sx = qm.quantize_channel(x, axis=1, dtype="fp8")
    qw_t, sw_t = qm.quantize_channel(w.t(), axis=1, dtype="fp8")
    return x, w, qx, qw_t.contiguous(), sx, sw_t.reshape(1, n)


def _qmm_f8_close(got, ref):
    """Each row within 1e-3 of its own max |y| (f32 sums in two orders)."""
    err = (got.float() - ref).abs().amax(-1)
    assert bool((err <= 1e-3 * ref.abs().amax(-1)).all())


@pytest.mark.parametrize("m", [1, 8, 16, 17, 64, 65, 129, 512, 1000])
@pytest.mark.parametrize("k,n", [(256, 384), (8192, 2048), (2048, 6144)])
def test_qmm_f8_kernel_matches_plain(gen, m, k, n):
    """Row 10f in both regimes: f32 output within 1e-3 of each row's max
    |y| of the plain version, its bf16 and fp16 outputs the f32 output
    rounded, two calls bitwise equal, one launch a call."""
    _, _, qx, qw_t, sx, sw = _qmm_f8_operands(gen, m, k, n)
    launches = qm.QUANTIZED_MATMUL_F8.launches
    got = qm._qmm_cuda(qx, qw_t, sx, sw, torch.float32)
    assert qm.QUANTIZED_MATMUL_F8.launches == launches + 1
    _qmm_f8_close(got, qm._qmm_plain(qx, qw_t.t(), sx, sw, torch.float32))
    assert torch.equal(qm._qmm_cuda(qx, qw_t, sx, sw, torch.float32), got)
    for out in (torch.bfloat16, torch.float16):
        assert torch.equal(qm._qmm_cuda(qx, qw_t, sx, sw, out), got.to(out))


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("m", [17, 100, 300])
def test_qmm_f8_kernel_forced_splits_match_plain(gen, monkeypatch, m, splits):
    """Every split of K (the pieces added in split order) over N = 384
    (a 128-wide tile each third), through plans the wrapper would not
    choose here."""
    plan = qm._qmm_plan
    monkeypatch.setattr(qm, "_qmm_plan", lambda m_, n_, k_, sms, bn=None: plan(
        m_, n_, k_, sms, bn, splits))
    _, _, qx, qw_t, sx, sw = _qmm_f8_operands(gen, m, 768, 384)
    got = qm._qmm_cuda(qx, qw_t, sx, sw, torch.float32)
    _qmm_f8_close(got, qm._qmm_plain(qx, qw_t.t(), sx, sw, torch.float32))
    assert torch.equal(qm._qmm_cuda(qx, qw_t, sx, sw, torch.float32), got)


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "fresh"])
@pytest.mark.parametrize("m,k,n", [(8, 8192, 2048), (512, 8192, 2048)])
def test_qmm_f8_kernel_graph_replays_equal_eager(gen, m, k, n, warm):
    """Row 10f from a CUDA graph equals eager bit for bit: at M = 8 a
    strip's pieces (several blocks) and at M = 512 the K splits are added
    in piece order, whoever arrives last."""
    _, _, qx, qw_t, sx, sw = _qmm_f8_operands(gen, m, k, n)
    plan = qm._qmm_plan(m, n, k, qm._sm_count(qx.device),
                        bn=None if m <= 16 else 128)
    assert plan["pieces"] > 1 or plan["splits"] > 1
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        eager = qm._qmm_cuda(qx, qw_t, sx, sw, torch.bfloat16)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream if warm else None):
            out = qm._qmm_cuda(qx, qw_t, sx, sw, torch.bfloat16)
    torch.cuda.current_stream().wait_stream(stream)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.parametrize("case", ["mixed", "width", "bn256", "layout"])
def test_qmm_f8_kernel_raises_instead_of_falling_back(gen, monkeypatch, case):
    """e4m3 activations with int8 weights, N not a multiple of 128, a
    256-wide prefill tile (the e4m3 kernel has 128-wide tiles only: the
    launch is refused and the wrapper raises) and a strided weight raise
    on the card, and nothing is launched."""
    _, _, qx, qw_t, sx, sw = _qmm_f8_operands(gen, 64, 256, 384)
    n = qm.QUANTIZED_MATMUL_F8.launches
    if case == "mixed":
        qw_t = qw_t.view(torch.int8)
    elif case == "width":
        qw_t, sw = qw_t[:96].contiguous(), sw[:, :96].contiguous()
    elif case == "bn256":
        plan = qm._qmm_plan
        monkeypatch.setattr(qm, "_qmm_plan", lambda m_, n_, k_, sms, bn=None:
                            plan(m_, n_, k_, sms, 256, 1))
        qw_t, sw = (torch.cat([qw_t.view(torch.uint8)] * 2)
                    .view(torch.float8_e4m3fn), torch.cat([sw, sw], 1))
    else:
        qw_t = qw_t.t().contiguous().t()
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        qm._qmm_cuda(qx, qw_t, sx, sw, torch.bfloat16)
    assert qm.QUANTIZED_MATMUL_F8.launches == n


def test_fake_quant_matmul_f8_on_the_card(gen):
    """fp8 QAT's op on the card: its forward within 1e-3 of the CPU's on
    the same inputs (the same codes; f32 sums in other orders), its
    straight-through gradients within 1e-5."""
    x = torch.randn((4, 9, 128), generator=gen, device="cuda")
    w = torch.randn((128, 256), generator=gen, device="cuda") * 0.1
    g = torch.randn((4, 9, 256), generator=gen, device="cuda")
    outs, grads = [], []
    for dev in ("cuda", "cpu"):
        xs, ws = (a.detach().to(dev, copy=True).requires_grad_()
                  for a in (x, w))
        y = qm.fake_quant_matmul(xs, ws, "fp8")
        (y * g.to(dev)).sum().backward()
        outs.append(y.detach().cpu())
        grads.append((xs.grad.cpu(), ws.grad.cpu()))
    assert (outs[0] - outs[1]).abs().max() <= 1e-3 * outs[1].abs().max()
    for a, b in zip(*grads):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.parametrize("kw", [dict(), dict(kv_layout="paged",
                                             kv_block_size=16)],
                         ids=["dense", "paged"])
def test_fp8_engine_on_the_card(gen, kw):
    """A 2-layer fp8-cache engine with fp8 compute on the card: the e4m3
    kernels only (four row-10f launches a layer a step, one row 5f / 7f a
    layer a decode step), one host sync a decode step."""
    from paddle_tpu_torch.inference import InferenceEngine
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.ops import KERNELS
    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                    num_heads=2, max_seq_len=256, quantize="fp8")
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=gen).eval()
    eng = InferenceEngine(model, batch_slots=2, kv_dtype="fp8",
                          device="cuda", **kw)
    for kernel in KERNELS.values():
        kernel.launches = 0
    rng = torch.Generator().manual_seed(0)
    rids = [eng.add_request(torch.randint(0, 512, (n,), generator=rng)
                            .numpy(), max_new_tokens=6) for n in (5, 40)]
    out = eng.run()
    st = eng.stats()
    assert all(len(out[r]) == 6 for r in rids)
    launches = {k.symbol: k.launches for k in KERNELS.values() if k.launches}
    decode = ("paged_" if kw else "") + "decode_attention_f8"
    assert launches == {
        "quantized_matmul_f8": 4 * 2 * (st["prefills"] + st["decode_steps"]),
        decode: 2 * st["decode_steps"], "flash_fwd": 2 * st["prefills"]}
    assert st["decode_host_syncs"] == st["decode_steps"]


# ---- decoding API and optimizers on the card ---------------------------

def test_beam_search_tie_order_on_the_card(gen):
    """Equal totals in one row of the top-k: the card's search keeps
    ``lax.top_k``'s order (the lower flat index first), as the CPU search
    does, over a vocabulary of 50304 with 4 beams (the t = 0 rows of
    beams 1-3 tie at -1e9 in f32, and so do finished beams)."""
    dec = importlib.import_module("paddle_tpu_torch.text.decoding")
    v, eos, bos = 50304, 0, 1
    table = torch.full((8, v), -5.0)
    table[bos, 3] = table[bos, 5] = table[bos, 7] = 2.0
    table[3:8, eos] = 1.0

    def step(tokens, state):
        return table.to(tokens.device)[tokens.long().clamp(max=7)], state
    seqs, scores = {}, {}
    for device in ("cpu", "cuda"):
        s, sc = dec.beam_search(step, (), 2, 4, 5, bos, eos, device=device)
        seqs[device], scores[device] = s.cpu(), sc.cpu()
    assert torch.equal(seqs["cuda"], seqs["cpu"])
    torch.testing.assert_close(scores["cuda"], scores["cpu"])
    assert seqs["cuda"][0, :3, 0].tolist() == [3, 5, 7]


@pytest.mark.parametrize("rule", ["lamb", "lars", "adamax", "lookahead"])
def test_optimizer_with_device_step_on_the_card(gen, rule):
    """Lamb, Lars, Adamax and LookAhead(Adam) with the step count an
    int32 tensor on the card: the same update as on the CPU (f64 copies,
    rtol 1e-5), and no host read."""
    topt = importlib.import_module("paddle_tpu_torch.optimizer")
    inc = importlib.import_module("paddle_tpu_torch.incubate")
    make = {"lamb": lambda: topt.Lamb(1e-2, lamb_weight_decay=0.05),
            "lars": lambda: topt.Lars(0.1, lars_coeff=0.01),
            "adamax": lambda: topt.Adamax(1e-2),
            "lookahead": lambda: inc.LookAhead(topt.Adam(1e-2), k=2)}[rule]
    p = {"w": torch.randn(64, 32, generator=gen, device="cuda"),
         "b": torch.randn(32, generator=gen, device="cuda")}
    ref = {n: t.double().cpu() for n, t in p.items()}
    on_card, on_cpu = make(), make()
    for step in range(1, 4):
        g = {n: torch.randn(t.shape, generator=gen, device="cuda")
             for n, t in p.items()}
        reads = []
        orig = torch.Tensor.item
        torch.Tensor.item = lambda t, *a, **k: reads.append(1) or orig(t)
        try:
            on_card.apply_gradients(
                p, g, step=torch.tensor(step, dtype=torch.int32,
                                        device="cuda"))
        finally:
            torch.Tensor.item = orig
        assert not reads
        on_cpu.apply_gradients(ref, {n: t.double().cpu()
                                     for n, t in g.items()}, step=step)
    for n in p:
        torch.testing.assert_close(p[n].cpu().double(), ref[n], rtol=1e-5,
                                   atol=1e-6)


# ---- kernel state under threads and streams ------------------------------------

@pytest.mark.parametrize("kinds", [("dense", "paged"), ("dense", "dense"),
                                   ("paged", "paged")],
                         ids=["11a+11c", "11a+11a", "11c+11c"])
def test_megakernel_on_two_streams_at_once(gen, kinds):
    """Two threads, each on a stream of its own, launch the megakernel
    (dense 11a / paged 11c, bf16) 20 times on different inputs at once:
    each stream gets its own workspace, every output equals the first
    launch's bitwise and ``_mega_plain`` within the row tolerance."""
    mk = importlib.import_module("paddle_tpu_torch.ops.decode_megakernel")
    blk = _mega_block(gen, 256, 2, 2, 512)
    cases = [_mega_case(gen, blk, lens, False, None if kind == "dense"
                        else 16)
             for kind, lens in zip(kinds, ([3, 90, 255, 0, 17],
                                           [200, 1, 64, 128, 33, 250]))]
    refs = [_mega_run(blk, c, plain=True) for c in cases]
    streams = [torch.cuda.Stream() for _ in cases]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    barrier = threading.Barrier(2)

    def launch(i):
        with torch.cuda.stream(streams[i]):
            barrier.wait()
            for _ in range(20):
                outs[i].append(_mega_run(blk, cases[i]))
            streams[i].synchronize()

    threads = [threading.Thread(target=launch, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    keys = {(s.device_index, s.cuda_stream) for s in streams}
    assert keys <= set(mk._WORK)
    assert len({mk._WORK[k].data_ptr() for k in keys}) == 2
    for got, ref in zip(outs, refs):
        assert len(got) == 20
        for out in got:
            for g, first, r in zip(out, got[0], ref):
                assert torch.equal(g, first)
                _close(g, r)


def test_cold_build_from_two_threads(gen, monkeypatch, tmp_path):
    """Two threads load one cold source at once into an empty build
    directory: one nvcc run, one library for both."""
    from paddle_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    runs = []
    popen = _build.subprocess.Popen

    def counted(cmd, *a, **k):
        runs.append(cmd)
        return popen(cmd, *a, **k)
    monkeypatch.setattr(_build.subprocess, "Popen", counted)
    barrier = threading.Barrier(2)
    libs = [None, None]

    def load(i):
        barrier.wait()
        libs[i] = _build._load("philox_check.cu")

    threads = [threading.Thread(target=load, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert len(runs) == 1
    assert libs[0] is not None and libs[0] is libs[1]
    assert _build.library_path("philox_check.cu").parent == tmp_path
    assert [p.name for p in tmp_path.iterdir()] == \
        [_build.library_path("philox_check.cu").name]


# ---- the layer API's attention route (nn.MultiHeadAttention,
# nn.Transformer) on the card ------------------------------------------

def _on_cpu(build):
    """``build()`` with the layer API's device set to the CPU, then the
    device it had."""
    from paddle_tpu_torch import device
    import paddle_tpu_torch as tp
    was = device._current
    tp.set_device("cpu")
    try:
        return build()
    finally:
        device._current = was


def _layer_pair(gen, build):
    import copy
    cpu = _on_cpu(build)
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(torch.randn(p.shape, generator=gen,
                                device="cuda").cpu() * 0.05 + p)
    return cpu.eval(), copy.deepcopy(cpu).cuda().eval()


def test_layer_api_attention_on_the_card_equals_the_cpu(gen):
    """MultiHeadAttention (D=64, no mask: rows 1; a mask: the composite)
    and a small Transformer (d_model 128, 2 heads of 64, 1 + 1 layers,
    the causal target mask) under auto_cast bf16: the card's output
    within 1e-2 of the CPU plain route's max |value|, row by row."""
    import paddle_tpu_torch as tp
    from paddle_tpu_torch import nn
    mha_cpu, mha = _layer_pair(gen, lambda: nn.MultiHeadAttention(128, 2))
    tr_cpu, tr = _layer_pair(gen, lambda: nn.Transformer(
        128, 2, 1, 1, 256, dropout=0.0))
    x = torch.randn((2, 160, 128), generator=gen, device="cuda")
    y = torch.randn((2, 96, 128), generator=gen, device="cuda")
    mask = tr.generate_square_subsequent_mask(96)
    with torch.no_grad(), tp.amp.auto_cast(dtype="bfloat16"):
        pairs = [(mha(x), mha_cpu(x.cpu())),
                 (mha(y, x, x), mha_cpu(y.cpu(), x.cpu(), x.cpu())),
                 (mha(y, attn_mask=mask),
                  mha_cpu(y.cpu(), attn_mask=mask.cpu())),
                 (tr(x, y, tgt_mask=mask),
                  tr_cpu(x.cpu(), y.cpu(), tgt_mask=mask.cpu()))]
    for got, ref in pairs:
        assert got.dtype == ref.dtype
        _close(got.cpu(), ref.float(), floor=1.0)


def test_layer_api_route_counts_on_the_card(gen):
    """Unmasked bf16 attention at D=64 launches rows 1-3 (their dropout
    forms in training); a masked one, an f32 one and one at D=32 call
    the composite, which the counter counts."""
    import paddle_tpu_torch as tp
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn.functional import attention
    counters = {"fwd": fa.FLASH_FWD, "dq": fa.FLASH_BWD_DQ,
                "dkv": fa.FLASH_BWD_DKV, "fwd_p": fa.FLASH_FWD_DROPOUT,
                "dq_p": fa.FLASH_BWD_DQ_DROPOUT,
                "dkv_p": fa.FLASH_BWD_DKV_DROPOUT,
                "composite": attention.COMPOSITE}

    def count(fn):
        before = {k: c.launches for k, c in counters.items()}
        fn()
        torch.cuda.synchronize()
        return {k: c.launches - before[k] for k, c in counters.items()
                if c.launches != before[k]}

    _, mha = _layer_pair(gen, lambda: nn.MultiHeadAttention(128, 2))
    _, narrow = _layer_pair(gen, lambda: nn.MultiHeadAttention(128, 4))
    _, tr = _layer_pair(gen, lambda: nn.Transformer(
        128, 2, 2, 2, 256, dropout=0.1))
    x = torch.randn((2, 64, 128), generator=gen, device="cuda")
    mask = tr.generate_square_subsequent_mask(64)
    with torch.no_grad():
        with tp.amp.auto_cast(dtype="bfloat16"):
            assert count(lambda: mha(x)) == {"fwd": 1}
            assert count(lambda: mha(x, attn_mask=mask)) == {"composite": 1}
            assert count(lambda: narrow(x)) == {"composite": 1}   # D=32
        assert count(lambda: mha(x)) == {"composite": 1}          # f32
    tr.train()

    def step():
        with tp.amp.auto_cast(dtype="bfloat16"):
            out = tr(x, x, tgt_mask=mask)
        out.float().square().mean().backward()

    assert count(step) == {"fwd_p": 4, "dq_p": 4, "dkv_p": 4,
                           "composite": 2}
    tr.eval()
    with torch.no_grad(), tp.amp.auto_cast(dtype="bfloat16"):
        assert count(lambda: tr(x, x, tgt_mask=mask)) == {
            "fwd": 4, "composite": 2}


# ---- vision ----------------------------------------------------------------

@pytest.mark.parametrize("n,c,side", [(2, 8, 16), (4, 16, 15), (1, 4, 33)])
def test_vision_ops_bf16_on_the_card_match_cpu_f32(gen, n, c, side):
    """conv2d (stride 2, 'SAME'; a 3 x 3 with groups), max and average
    pools (ceil_mode, exclusive), and batch norm in training under
    auto_cast bf16 on the card against the same calls in f32 on the CPU:
    within 2e-2 of each output's max |value| (bf16 operands, 2^-8 each;
    the norms' statistics in f32 on both sides)."""
    import paddle_tpu_torch as tp
    from paddle_tpu_torch.nn import functional as F
    x = torch.randn((n, c, side, side), generator=gen, device="cuda")
    w = torch.randn((c, c // 2, 3, 3), generator=gen, device="cuda") * 0.2
    w1 = torch.randn((2 * c, c, 3, 3), generator=gen, device="cuda") * 0.2
    gamma = torch.rand((2 * c,), generator=gen, device="cuda") + 0.5
    beta = torch.randn((2 * c,), generator=gen, device="cuda")

    def run(x, w, w1, gamma, beta):
        rm = torch.zeros(2 * c, device=x.device)
        rv = torch.ones(2 * c, device=x.device)
        y = F.conv2d(x, w1, stride=2, padding="SAME")
        y = F.batch_norm(y, rm, rv, gamma, beta, training=True)
        return [y, F.conv2d(x, w, padding=1, groups=2),
                F.max_pool2d(y, 3, 2, 1, ceil_mode=True),
                F.avg_pool2d(y, 3, 2, 1, ceil_mode=True),
                F.adaptive_avg_pool2d(y, 3), rm, rv]

    with tp.amp.auto_cast(dtype="bfloat16"):
        card = run(x, w, w1, gamma, beta)
    cpu = run(*(t.cpu() for t in (x, w, w1, gamma, beta)))
    assert card[1].dtype == torch.bfloat16 and card[0].dtype == torch.float32
    # a running mean (0.1 x a batch mean near 0) is held to 0.1 x its
    # channels' largest batch standard deviation
    batch_std = ((cpu[-1] - 0.9) / 0.1).max().sqrt()
    scales = [ref.abs().max() for ref in cpu[:-2]] + [0.1 * batch_std,
                                                      cpu[-1].abs().max()]
    for got, ref, scale in zip(card, cpu, scales):
        err = (got.float().cpu() - ref).abs().max()
        assert err <= 2e-2 * scale, float(err / scale)


@pytest.mark.parametrize("shape,fmt", [((8, 16, 12, 12), "NCHW"),
                                       ((4, 10, 10, 24), "NHWC"),
                                       ((64, 32), "NCHW")])
def test_vision_batch_norm_running_stats_on_the_card_equal_cpu(gen, shape,
                                                               fmt):
    """Three training steps of Paddle's update (momentum 0.9, biased
    variance) in f32 on the card against the CPU: within 1e-5 of each
    buffer's scale."""
    from paddle_tpu_torch.nn import functional as F
    c = shape[-1] if fmt == "NHWC" else shape[1]
    bufs = {d: [torch.zeros(c, device=d), torch.ones(c, device=d)]
            for d in ("cuda", "cpu")}
    for _ in range(3):
        x = torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5
        for d, (rm, rv) in bufs.items():
            F.batch_norm(x.to(d), rm, rv, training=True, data_format=fmt)
    for got, ref in zip(bufs["cuda"], bufs["cpu"]):
        assert float((got.cpu() - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max().clamp_min(1.0))


def test_vision_resnet18_train_batch_launches_no_kernel(gen):
    """resnet18 through ``Model.train_batch`` on the card under auto_cast
    bf16 (Momentum, CrossEntropyLoss): finite losses, moved running
    statistics, and no launch of any hand-written kernel or of the
    attention composite."""
    import paddle_tpu_torch as tp
    from paddle_tpu_torch.nn.functional.attention import COMPOSITE
    from paddle_tpu_torch.ops import LAUNCHERS
    tp.set_device("gpu")
    tp.seed(3)
    net = tp.vision.models.resnet18(num_classes=10)
    m = tp.Model(net)
    m.prepare(tp.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                    parameters=net.parameters()),
              tp.nn.CrossEntropyLoss())
    before = {k.symbol: k.launches for k in (*LAUNCHERS.values(), COMPOSITE)}
    mean0 = net.bn1._mean.clone()
    losses = []
    with tp.amp.auto_cast(dtype="bfloat16"):
        for _ in range(3):
            x = torch.randn((8, 3, 64, 64), generator=gen, device="cuda")
            y = torch.randint(0, 10, (8, 1), generator=gen, device="cuda")
            losses.append(m.train_batch([x], [y])[0])
    after = {k.symbol: k.launches for k in (*LAUNCHERS.values(), COMPOSITE)}
    assert after == before
    assert all(torch.isfinite(torch.tensor(losses)))
    assert not torch.equal(net.bn1._mean, mean0)


# ---- detection ops and DataLoader workers -----------------------------------

def test_detection_box_ops_on_the_card_equal_cpu(gen):
    """Box math, box coding, NMS, multiclass NMS and the YOLO ops in f32
    on the card against the CPU: within 1e-5 of max(|cpu|, 1) elementwise
    (the YOLO loss and its gradient: of their largest magnitude); NMS
    keep lists and multiclass rows equal (no IoU here lies within 1e-5
    of a threshold: checked)."""
    from paddle_tpu_torch.vision import ops as V
    xy = torch.rand((300, 2), generator=gen, device="cuda") * 200
    wh = torch.rand((300, 2), generator=gen, device="cuda") * 40 + 4
    boxes = torch.cat([xy, xy + wh], 1)
    scores = torch.rand((300,), generator=gen, device="cuda")
    deltas = torch.randn((300, 4), generator=gen, device="cuda")
    cpu_boxes = boxes.cpu()
    assert not bool(((V.box_iou(cpu_boxes, cpu_boxes) - 0.5).abs()
                     <= 1e-5).triu(1).any())

    def close(got, ref, total=False):
        got, ref = got.detach().float().cpu(), ref.detach().float()
        scale = ref.abs().max() if total else ref.abs().clamp_min(1.0)
        assert bool(((got - ref).abs() <= 1e-5 * scale).all())

    for fn in (lambda b: V.box_area(b), lambda b: V.box_iou(b[:50], b),
               lambda b: V.box_clip(b, (150, 180)),
               lambda b: V.box_coder(b, deltas.to(b.device),
                                     "decode_center_size", (.1, .1, .2, .2)),
               lambda b: V.box_coder(b[:, None], b[None, :20] + 3.0)):
        close(fn(boxes), fn(cpu_boxes))
    keep = V.nms(boxes, scores, 0.5, top_k=50)
    assert keep.device.type == "cuda"
    assert torch.equal(keep.cpu(), V.nms(cpu_boxes, scores.cpu(), 0.5,
                                         top_k=50))
    cls = torch.rand((6, 300), generator=gen, device="cuda") ** 3
    det = V.multiclass_nms(boxes, cls, nms_threshold=0.5)
    assert det.device.type == "cuda"
    assert torch.equal(det.cpu(), V.multiclass_nms(cpu_boxes, cls.cpu(),
                                                   nms_threshold=0.5))
    x = torch.randn((2, 3 * 8, 5, 6), generator=gen, device="cuda") * 0.5
    img = torch.tensor([[160, 192], [100, 120]], device="cuda")
    anchors = [10, 13, 16, 30, 33, 23]
    for got, ref in zip(V.yolo_box(x, img, anchors, 3, 0.3, 32),
                        V.yolo_box(x.cpu(), img.cpu(), anchors, 3, 0.3, 32)):
        close(got, ref)
    gt = torch.cat([torch.rand((2, 4, 2), generator=gen, device="cuda") * 0.8
                    + 0.1, torch.rand((2, 4, 2), generator=gen,
                                      device="cuda") * 0.4 + 0.05], -1)
    lab = torch.randint(0, 3, (2, 4), generator=gen, device="cuda")
    out = []
    for dev in ("cuda", "cpu"):
        xs = x.to(dev).detach().requires_grad_()
        loss = V.yolo_loss(xs, gt.to(dev), lab.to(dev), anchors * 3,
                           [0, 1, 2], 3, 0.7, 32)
        loss.sum().backward()
        out.append((loss, xs.grad))
    close(out[0][0], out[1][0], total=True)
    close(out[0][1], out[1][1], total=True)


def test_detection_sampling_ops_on_the_card_match_cpu(gen):
    """RoI align / pool and deformable convolution (with a mask) with
    their backward: f32 on the card within 1e-5 of each output's largest
    magnitude of the CPU's (sums in another order), bf16 on the card
    within 1e-2 of the CPU's f32 on the same values."""
    from paddle_tpu_torch.vision import ops as V
    x = torch.randn((2, 16, 20, 24), generator=gen, device="cuda").to(
        torch.bfloat16).float()
    xy = torch.rand((12, 2), generator=gen, device="cuda") * 300
    boxes = torch.cat([xy, xy + torch.rand((12, 2), generator=gen,
                                           device="cuda") * 100 + 8], 1)
    num = torch.tensor([5, 7], device="cuda")
    cot = torch.randn((12, 16, 7, 7), generator=gen, device="cuda")

    def rel(got, ref):
        return float((got.float().cpu() - ref).abs().max() / ref.abs().max())

    for op in (V.roi_align, V.roi_pool):
        res = []
        for xs, b, n, c in ((x, boxes, num, cot),
                            (x.cpu(), boxes.cpu(), num.cpu(), cot.cpu())):
            xs = xs.detach().requires_grad_()
            out = op(xs, b, n, output_size=7, spatial_scale=1 / 16)
            out.backward(c)
            res.append((out, xs.grad))
        (out, g), (cpu_out, cpu_g) = res
        assert rel(out, cpu_out) <= 1e-5 and rel(g, cpu_g) <= 1e-5
        half = op(x.to(torch.bfloat16), boxes, num, output_size=7,
                  spatial_scale=1 / 16)
        assert half.dtype == torch.bfloat16 and rel(half, cpu_out) <= 1e-2
    off = torch.randn((2, 18, 20, 24), generator=gen, device="cuda")
    mask = torch.rand((2, 9, 20, 24), generator=gen, device="cuda")
    w = torch.randn((8, 16, 3, 3), generator=gen, device="cuda") * 0.1
    dcot = torch.randn((2, 8, 20, 24), generator=gen, device="cuda")
    res = []
    for dev in ("cuda", "cpu"):
        args = [t.to(dev).detach().requires_grad_() for t in (x, off, w, mask)]
        out = V.deform_conv2d(args[0], args[1], args[2], padding=1,
                              mask=args[3])
        out.backward(dcot.to(dev))
        res.append([out] + [a.grad for a in args])
    for got, ref in zip(*res):
        assert rel(got, ref) <= 1e-5
    half = V.deform_conv2d(x.to(torch.bfloat16), off, w.to(torch.bfloat16),
                           padding=1, mask=mask.to(torch.bfloat16))
    assert half.dtype == torch.bfloat16 and rel(half, res[1][0]) <= 1e-2


class _SquareDS:
    def __len__(self):
        return 37

    def __getitem__(self, i):
        return (torch.full((3, 4), float(i)).numpy(),
                torch.tensor([i * i]).numpy())


def test_worker_loader_forks_after_cuda_init(gen):
    """A process that already made CUDA tensors forks two DataLoader
    workers (they touch no CUDA): batches land on the card equal to
    ``num_workers=0``'s, and no child or ring is left."""
    import multiprocessing as mp
    import os
    import paddle_tpu_torch as tp
    tp.set_device("gpu")
    assert torch.randn((4,), generator=gen, device="cuda").is_cuda
    ref = list(tp.io.DataLoader(_SquareDS(), batch_size=5))
    loader = tp.io.DataLoader(_SquareDS(), batch_size=5, num_workers=2,
                              timeout=60)
    got = list(loader)
    st = loader.worker_stats
    assert st["mode"] == "processes" and len(st["producers"]) == 2
    assert len(got) == len(ref) == 8
    for (a, b), (c, d) in zip(got, ref):
        assert a.is_cuda and torch.equal(a, c) and torch.equal(b, d)
    assert mp.active_children() == []
    assert not any(os.path.exists(f"/dev/shm/{n}") for n in st["rings"])


# the op library and row-sparse embedding gradients

TENSOR_MODULES = ["creation", "math", "manipulation", "logic", "search",
                  "linalg", "random", "attribute", "einsum", "sequence",
                  "array"]


@pytest.mark.parametrize("module", TENSOR_MODULES)
def test_tensor_module_on_the_card_equals_the_cpu(gen, module):
    """Every op of one module of ``paddle_tpu_torch.tensor`` in
    chip_smoke's tensor-ops table, on the card against the CPU within
    the table's bounds (TOL_OPS_*)."""
    cs = importlib.import_module("chip_smoke")
    import paddle_tpu_torch as tp
    names = set(importlib.import_module(
        f"paddle_tpu_torch.tensor.{module}").__all__)
    tp.seed(1234)
    card_in, cpu_in = cs.ops_inputs("cuda"), cs.ops_inputs("cpu")
    checked, bad = set(), []
    for name, kind, call in cs._ops_table():
        if name not in names:
            continue
        err, bound, _ = cs.ops_check(name, kind, call, card_in, cpu_in)
        checked.add(name)
        if err > (bound or 0.0):
            bad.append((name, kind, err, bound))
    assert checked == names and not bad, (names - checked, bad)


def _sparse_table(vocab, dim, device, seed=0):
    import paddle_tpu_torch as tp
    from paddle_tpu_torch import nn
    tp.seed(seed)
    return nn.Embedding(vocab, dim, sparse=True, device=device)


def test_lazy_adam_step_reads_nothing_back_on_the_card(gen):
    """A sparse lazy-Adam step (merge, moments and rows) raises no error
    under ``set_sync_debug_mode('error')`` and equals the CPU's."""
    import paddle_tpu_torch as tp
    ids = torch.randint(0, 1000, (64, 26), generator=gen, device="cuda")
    start = _sparse_table(1000, 9, "cpu").state_dict()
    out = {}
    for dev in ("cuda", "cpu"):
        emb = _sparse_table(1000, 9, dev)
        emb.set_state_dict({k: v.to(dev) for k, v in start.items()})
        opt = tp.optimizer.Adam(1e-2, parameters=emb.parameters(),
                                lazy_mode=True)
        for _ in range(2):
            (emb(ids.to(dev)) ** 2).sum().backward()
            assert emb.weight.grad.is_sparse
            if dev == "cuda":
                torch.cuda.set_sync_debug_mode("error")
            try:
                opt.step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            opt.clear_grad()
        out[dev] = emb.weight.detach().cpu()
    err = (out["cuda"] - out["cpu"]).abs().max() / out["cpu"].abs().max()
    assert err <= 1e-5, float(err)


def test_minus_one_ids_update_the_last_row_on_the_card(gen):
    """-1 reads and updates the table's last row (the JAX package's
    reading of InMemoryDataset's padding): one lazy Adam step at lr 0.1
    moves rows 1, 2 and 4 of a 5-row table by -0.1."""
    import paddle_tpu_torch as tp
    emb = _sparse_table(5, 2, "cuda")
    w0 = emb.weight.detach().clone()
    ids = torch.tensor([[1, -1], [2, 1]], device="cuda")
    out = emb(ids)
    assert torch.equal(out[0, 1], w0[4])
    opt = tp.optimizer.Adam(0.1, parameters=emb.parameters(), lazy_mode=True)
    out.sum().backward()
    opt.step()
    moved = (emb.weight.detach() - w0).cpu()
    assert torch.allclose(moved[[1, 2, 4]], torch.full((3, 2), -0.1),
                          rtol=1e-5, atol=0)
    assert (moved[[0, 3]] == 0).all()


# ---------------------------------------------------------------------------
# rows 1-3 as torch.library custom ops inside captured programs
# ---------------------------------------------------------------------------
def _flash_inputs(gen, b, s=256, h=4, d=64):
    return [_rand((b, s, h, d), gen).requires_grad_() for _ in range(3)]


class _Attend(torch.nn.Module):
    def __init__(self, p=0.0):
        super().__init__()
        self.p = p

    def forward(self, q, k, v):
        from paddle_tpu_torch.ops import flash_attention
        return flash_attention(q, k, v, causal=True, dropout_p=self.p)


def test_flash_ops_under_export_equal_the_eager_call(gen):
    """The exported program calls paddle_tpu::flash_fwd (no library
    attention), equals the eager call bitwise in its output and its
    gradients, and launches the forward, dq and dk/dv kernels once
    each a call."""
    from paddle_tpu_torch import ops
    q, k, v = _flash_inputs(gen, 2)
    ep = torch.export.export(_Attend(), (q, k, v))
    targets = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
    assert any("paddle_tpu.flash_fwd" in t for t in targets)
    assert not any("scaled_dot_product" in t for t in targets)
    do = _rand(q.shape, gen)
    counts = [ops.FLASH_FWD.launches, ops.FLASH_BWD_DQ.launches,
              ops.FLASH_BWD_DKV.launches]
    got = ep.module()(q, k, v)
    got_g = torch.autograd.grad(got, (q, k, v), do)
    assert [ops.FLASH_FWD.launches, ops.FLASH_BWD_DQ.launches,
            ops.FLASH_BWD_DKV.launches] == [c + 1 for c in counts]
    want = _Attend()(q, k, v)
    want_g = torch.autograd.grad(want, (q, k, v), do)
    assert torch.equal(got, want)
    for a, b in zip(got_g, want_g):
        assert torch.equal(a, b)


def test_none_batch_export_runs_at_two_batch_sizes(gen, tmp_path):
    """jit.save with a None batch dim; the loaded program on the card at
    B = 1 and 3 against the eager layer within 1e-2 of each row's
    scale, row 1 launched once a call."""
    import paddle_tpu_torch as tp
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.static import InputSpec
    tp.set_device("gpu")
    mha = tp.nn.MultiHeadAttention(256, 4).cuda()
    mha.eval()
    path = str(tmp_path / "mha")
    with tp.amp.auto_cast(dtype="bfloat16"):
        tp.jit.save(mha, path, input_spec=[InputSpec([None, 128, 256])] * 3)
    pred = tp.inference.load_predictor(path)
    for b in (1, 3):
        x = torch.randn(b, 128, 256, generator=gen, device="cuda")
        before = ops.FLASH_FWD.launches
        got = pred(x, x, x)
        assert ops.FLASH_FWD.launches == before + 1
        with torch.no_grad(), tp.amp.auto_cast(dtype="bfloat16"):
            want = mha(x, x, x)
        _close(got, want.float())


def test_dropout_pair_is_fresh_in_a_loaded_program(gen, tmp_path):
    """A program saved with the attention's dropout form draws its
    (seed, offset) pair in the graph: two calls differ, and each runs the
    dropout kernel."""
    from paddle_tpu_torch import ops
    q, k, v = (t.detach() for t in _flash_inputs(gen, 1))
    ep = torch.export.export(_Attend(0.1), (q, k, v))
    path = str(tmp_path / "drop.pt2")
    torch.export.save(ep, path)
    loaded = torch.export.load(path).module()
    before = ops.FLASH_FWD_DROPOUT.launches
    a, b = loaded(q, k, v), loaded(q, k, v)
    assert ops.FLASH_FWD_DROPOUT.launches == before + 2
    assert not torch.equal(a, b)


def test_lstm_on_the_card_against_the_cpu(gen):
    """nn.LSTM (2 layers, bidirectional) through cuDNN against the same
    weights on the CPU: outputs and final states within 1e-2 of each
    tensor's max |CPU value| (cuDNN's TF32 on, as by default), and the
    gradients of the input and of every weight within 1e-2 likewise; no
    cuDNN warning about weights outside one buffer, f32 or bf16; the
    parameters stay in one buffer across calls and an optimizer step,
    and a bf16 backward reaches every f32 parameter."""
    import paddle_tpu_torch as tp
    tp.set_device("gpu")
    tp.seed(0)
    card = tp.nn.LSTM(64, 64, num_layers=2, direction="bidirect")
    tp.set_device("cpu")
    cpu = tp.nn.LSTM(64, 64, num_layers=2, direction="bidirect")
    cpu.set_state_dict({k: v.detach().cpu()
                        for k, v in card.state_dict().items()})
    tp.set_device("gpu")
    x = torch.randn(8, 20, 64, generator=gen, device="cuda")
    xc = x.cpu().requires_grad_(True)
    x.requires_grad_(True)
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out, (h, c) = card(x)
        with tp.amp.auto_cast(dtype="bfloat16"):
            card(x)
    # the weights reach cuDNN in its own layout: no copy, no warning
    assert not [w for w in caught if "contiguous chunk" in str(w.message)]
    ptrs = [p.data_ptr() for p in card.parameters()]
    assert len({p.untyped_storage().data_ptr()
                for p in card.parameters()}) == 2      # one a layer
    ref, (rh, rc) = cpu(xc)
    for got, want in ((out, ref), (h, rh), (c, rc)):
        err = (got.detach().cpu() - want.detach()).abs().max()
        assert err <= 1e-2 * want.detach().abs().max()
    (out.sum() + h.sum()).backward()
    (ref.sum() + rh.sum()).backward()
    pairs = [(x.grad, xc.grad)] + [
        (p.grad, dict(cpu.named_parameters())[n].grad)
        for n, p in card.named_parameters()]
    for got, want in pairs:
        err = (got.cpu() - want).abs().max()
        assert err <= 1e-2 * want.abs().max()
    tp.optimizer.SGD(learning_rate=0.1,
                     parameters=card.parameters()).step()
    card.clear_gradients()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        card(x)
        with tp.amp.auto_cast(dtype="bfloat16"):
            out16, _ = card(x)
        out16.float().sum().backward()
    assert not [w for w in caught if "contiguous chunk" in str(w.message)]
    assert [p.data_ptr() for p in card.parameters()] == ptrs
    for n, p in card.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, n
        assert bool(torch.isfinite(p.grad).all()) and p.grad.abs().max() > 0


def test_distribution_samples_on_the_current_device(gen):
    """A distribution built from numbers lives and samples on the layer
    API's current device (the card), and two default draws differ."""
    import paddle_tpu_torch as tp
    from paddle_tpu_torch import distribution as D
    from paddle_tpu_torch.device import current_device
    tp.set_device("gpu")
    d = D.Normal(0.0, 1.0)
    a, b = d.sample([256]), d.sample([256])
    want = current_device()
    assert a.device == want and d.loc.device == want
    assert not torch.equal(a, b)
    assert D.Categorical([0.1, 0.5, 0.2]).sample([8]).device == want
    assert D.Uniform(0.0, 1.0).log_prob(0.5).device == want


def test_exported_train_step_steps_on_the_card(gen, tmp_path):
    """SpmdTrainer.export_train_step of a small Transformer under bf16
    AMP, stepped on the card by capi_bridge: 3 steps' losses within rel
    1e-4 of the live trainer's, rows 1-3 launched once a step each per
    attention (the program calls the custom ops): the encoder's
    self-attention, and the decoder's self- and cross-attention (no mask
    is given)."""
    import numpy as np
    import paddle_tpu_torch as tp
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.distributed import SpmdTrainer
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.inference import capi_bridge

    def build():
        tp.set_device("gpu")
        tp.seed(1)
        net = tp.nn.Transformer(d_model=128, nhead=2, num_encoder_layers=1,
                                num_decoder_layers=1, dim_feedforward=256,
                                dropout=0.0)
        opt = tp.optimizer.Adam(learning_rate=1e-3,
                                parameters=net.parameters())
        st = DistributedStrategy()
        st.amp = True
        return SpmdTrainer(net, opt, lambda o, y: tp.nn.functional.mse_loss(
            o.float(), y), strategy=st)

    rng = np.random.RandomState(3)
    src, tgt, lab = (rng.randn(2, 64, 128).astype(np.float32)
                     for _ in range(3))
    path = str(tmp_path / "tb")
    build().export_train_step(path, (src, tgt), lab)
    h = capi_bridge.create_trainer(path)
    live = build()
    for i in range(3):
        before = [ops.FLASH_FWD.launches, ops.FLASH_BWD_DQ.launches,
                  ops.FLASH_BWD_DKV.launches]
        raw, shape, dtype = capi_bridge.trainer_step(
            h, [(a.tobytes(), a.shape, "float32") for a in (src, tgt, lab)])
        after = [ops.FLASH_FWD.launches, ops.FLASH_BWD_DQ.launches,
                 ops.FLASH_BWD_DKV.launches]
        assert [a - b for a, b in zip(after, before)] == [3, 3, 3]
        got = float(np.frombuffer(raw, np.float32)[0])
        want = float(live.train_step((src, tgt), lab))
        assert abs(got - want) <= 1e-4 * abs(want), (i, got, want)
    capi_bridge.destroy_trainer(h)


def test_qmm_sweep_winner_is_bitwise_the_default_plan(gen, tmp_path,
                                                      monkeypatch):
    """``autotune_qmm_sweep`` at M = 64 and 512 (every plan of the built
    kernel): each candidate's output equals the default plan's (checked
    inside the sweep), the winner lands in the table with 'sweep'
    provenance, and a later product of that shape runs the winner's plan
    and equals the default plan's bit for bit."""
    from paddle_tpu_torch.utils import tuning
    monkeypatch.setenv("PADDLE_TPU_TUNING_CACHE", str(tmp_path / "t.json"))
    tuning.reset_for_tests()
    try:
        for m, n, k in ((64, 2048, 2048), (512, 6144, 2048)):
            win = qm.autotune_qmm_sweep(m, n, k, iters=3)
            key = (tuning.device_kind(), m, n, k, "int8")
            assert tuning.lookup("qmm_tiles", key) == win
            assert tuning.provenance("qmm_tiles", key)["source"] == "sweep"
            assert qm.get_qmm_tiles(m, n, k) == win
            x = torch.randn(m, k, device="cuda", generator=gen)
            w = torch.randn(k, n, device="cuda", generator=gen)
            y = qm.quantized_matmul(x, w, "int8", out_dtype=torch.float32)
            qx, sx = qm.quantize_channel(x, axis=1, dtype="int8")
            qw_t, sw = qm.quantize_channel(w.t(), axis=1, dtype="int8")
            ref = qm._qmm_cuda(qx.contiguous(), qw_t.contiguous(), sx,
                               sw.reshape(1, n), torch.float32, tiles={})
            assert torch.equal(y, ref)
    finally:
        tuning.reset_for_tests()


def test_live_episode_on_the_card_is_compile_free(gen, tmp_path,
                                                  monkeypatch):
    """A ``LiveRetuner`` episode on a warmed 2-layer engine on the card
    (dense and paged): no compile, a subset of the warmed buckets, and
    the engine serves on."""
    import numpy as np
    from paddle_tpu_torch.core import random as prandom
    from paddle_tpu_torch.inference import InferenceEngine
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.utils import compile_counter, tuning
    monkeypatch.setenv("PADDLE_TPU_TUNING_CACHE", str(tmp_path / "t.json"))
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE", "live")
    tuning.reset_for_tests()
    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                    num_heads=2, max_seq_len=512)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=prandom.seed(1, "cuda")).eval()
    for kw in ({}, {"kv_layout": "paged", "kv_block_size": 16}):
        eng = InferenceEngine(model, batch_slots=2, device="cuda", **kw)
        warmed = list(eng.buckets)
        eng.warmup(warmed)
        assert eng._retuner.notify_slo({"breached": True, "p99_ms": 1.0})
        with compile_counter.assert_no_recompiles("episode"):
            eng.step()
        r = eng._retuner
        assert r.episodes == 1 and not r.failures
        assert set(eng.buckets) <= set(warmed)
        out = eng.generate(np.arange(1, 40), max_new_tokens=4)
        assert len(out) == 4
    tuning.reset_for_tests()
