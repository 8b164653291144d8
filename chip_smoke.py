"""End-to-end check of paddle_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero
before the result lines:

1. device: CUDA device name, count and ``nvidia-smi`` name/power limit
   (no CUDA device: exit 2);
2. build: every ``paddle_tpu_torch/csrc/*.cu`` compiled by nvcc, all in
   parallel, with the compiler's register and spill report;
3. kernels: each serving kernel against its plain PyTorch version on the
   card at the serving path's shapes (bf16), with the stated tolerance,
   then timed (CUDA events) beside the plain version, one PyTorch library
   call computing the same function (a yardstick the port never calls)
   and the least time the card could take;
4. train-kernels: the flash backward kernels (dq, dk/dv) the same way at
   the training shape (B=4, S=2048, H=16, D=128, causal), ragged S, GQA,
   D=64 and a key mask with a fully masked row, each run twice (results
   must be bitwise equal); the fused cross-entropy at the training
   shape against full f32 logits, and its time;
5. serve: gpt3-1.3b in bf16 (random weights from a seed, full width and
   depth) behind ``InferenceEngine(batch_slots=8)``, 16 requests of 32
   new tokens; checks token counts, finite cache contents, one host sync
   per decode step, and that every prefill/decode layer launched the
   kernels (launch counts reset just before the run, read just after);
6. teacher-forced: prefill + 8 decode steps reproduce ``model.forward``
   over the same tokens within the stated bf16 tolerance;
7. profile: device time against wall time of steady decode steps
   (torch.profiler), the top kernels by device time;
8. train-parity: gpt3-1.3b width at 2 layers, f32 masters with bf16 AMP,
   one 2 x 512 batch through ``SpmdTrainer``: every parameter gradient
   of the kernel path against the same step with the plain attention
   swapped in by this script;
9. train: gpt3-1.3b at full width and depth, f32 masters, bf16 AMP,
   fused cross-entropy, Adam, batch 4 x 2048, fed by
   ``DevicePrefetcher``: 2 warm-up and 6 measured steps on one repeated
   batch (finite and falling loss, no host sync, 24 launches of each
   flash kernel per step, f32 masters; step ms, tokens/s, MFU, peak
   memory), one profiled step (device busy share, top kernels), then 2
   steps without and 2 with ``enable_recompute()`` from one saved state
   (equal losses, 48 forward launches per step, lower peak).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import importlib
import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor-core rate and
# HBM3 bandwidth, the denominators of bound_ms
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# tolerances, stated before measuring, held per output row (one query
# row of one head: a softmax over its own keys) so that long rows, whose
# outputs are small, are held to their own scale.  bf16 rounds each
# output to 8 significant bits (relative 2^-8) and the flash kernel also
# rounds p to bf16 before the p.v product, so a row's error is about
# 2^-8 of its largest element; the plain versions run in f32 on the same
# bf16 inputs
TOL_OUT = 1e-2      # x max|reference row|, per row
TOL_LSE = 1e-3      # x max(1, |reference lse|), per row, f32 on both sides
# prefill + decode vs one forward, both bf16 end to end through 24
# layers: different kernels and matmul shapes round differently
TOL_TEACHER = 5e-2  # x max|forward logits| of each position
# flash backward: p and ds are rounded to bf16 in series before their
# products and each gradient to bf16 at the end, against the plain
# version in f32 on the same bf16 inputs (and the kernel's own o, lse):
# a few 2^-8 of each row's largest element.  A row that cancels to zero
# in exact arithmetic (causal query 0 attends one key; a softmax over one
# key has no gradient) keeps only f32 rounding of dp - delta on both
# sides, so a row's scale is at least BWD_FLOOR x the tensor's max
TOL_BWD = 2e-2      # x max|reference row|, per row of dq, dk and dv
BWD_FLOOR = 1e-3
# fused cross-entropy: logits from bf16 operands are exact in TF32, so
# the loss is f32 rounding; d_logits keep TF32's 10 mantissa bits
# (2^-11 per element) in the backward products
TOL_CE_LOSS = 1e-4  # x max(1, |reference loss|), per row
TOL_CE_GRAD = 1e-2  # x max|reference gradient|, per tensor
# train-parity: bf16 AMP through two layers; the kernels round p, ds and
# o to bf16 where the plain attention keeps f32, and every later bf16
# product rounds on top
TOL_GRAD = 5e-2     # x max|plain gradient|, per parameter
# recompute runs the same kernels on the same inputs again
TOL_RECOMPUTE = 1e-3  # x |loss without recompute|, per step


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of operations over the bf16 peak
    and bytes over the memory rate."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {name} count={count} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    log(smi)
    return name, count, smi


def phase_build():
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"[build] {len(secs)} sources in {time.perf_counter() - t0:.2f} s "
        f"(parallel nvcc): " +
        ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()))
    for src in secs:
        lines = _build.build_log(src).splitlines()
        regs = [int(w) for line in lines if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt.startswith("registers")]
        spills = [line.strip() for line in lines if "spill" in line
                  and "0 bytes spill stores, 0 bytes spill loads" not in line]
        log(f"[build] {src}: {len(regs)} kernel instantiations, registers "
            f"per thread {min(regs, default=0)}-{max(regs, default=0)}, "
            f"spills: {spills or 'none'}")


def _rand(shape, gen, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def row_errors(got, ref, tol=TOL_OUT, floor=0.0):
    """Rows along the last axis: (max abs error, worst row's error over
    that row's max |ref|, whether every row is within ``tol`` of its own
    scale).  A row's scale is at least ``floor`` x the tensor's max |ref|;
    with no floor a row whose reference is all zeros must come out
    exactly 0."""
    err = (got.float() - ref).abs().amax(-1)
    scale = ref.abs().amax(-1).clamp_min(floor * ref.abs().max())
    ok = bool((err <= tol * scale).all().item())
    worst = (err / scale.clamp_min(1e-30)).max().item()
    return err.max().item(), worst, ok


def check_flash(gen, b, s, h, hkv, d, causal=True, mask=False):
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    q = _rand((b, s, h, d), gen)
    k = _rand((b, s, hkv, d), gen)
    v = _rand((b, s, hkv, d), gen)
    kv_mask = None
    if mask:
        kv_mask = (torch.rand((b, s), generator=gen, device="cuda") > 0.3
                   ).float().contiguous()
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, kv_mask=kv_mask)
    ro, rlse = fa._flash_plain(q.float(), k.float(), v.float(), causal,
                               kv_mask)
    torch.cuda.synchronize()
    err_o, worst_o, ok_o = row_errors(o, ro)
    dl = (lse - rlse).abs()
    err_l = dl.max().item()
    worst_l = (dl / rlse.abs().clamp_min(1.0)).max().item()
    ok = (ok_o and worst_l <= TOL_LSE and torch.isfinite(o).all().item())
    log(f"[kernels] flash B={b} S={s} H={h} Hkv={hkv} D={d} causal={causal} "
        f"mask={mask}: max|o-plain|={err_o:.3e} worst row "
        f"|o-plain|/max|plain row|={worst_o:.3e} (tol {TOL_OUT}) "
        f"max|lse-plain|={err_l:.3e} worst row {worst_l:.3e} "
        f"(tol {TOL_LSE}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"flash kernel disagrees with its plain version "
                         f"at B={b} S={s} H={h} Hkv={hkv} D={d}")
    return q, k, v, max(err_o, err_l), worst_o


def check_decode(gen, lengths, cap, h, hkv, d):
    da = importlib.import_module("paddle_tpu_torch.ops.decode_attention")
    b = len(lengths)
    q = _rand((b, h, d), gen)
    kc = _rand((b, cap, hkv, d), gen)
    vc = _rand((b, cap, hkv, d), gen)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    o = da.decode_attention(q, kc, vc, lens)
    ro = da._decode_plain(q.float(), kc.float(), vc.float(), lens)
    torch.cuda.synchronize()
    err, worst, ok_rows = row_errors(o, ro)
    zero_ok = all(o[i].abs().max().item() == 0.0
                  for i, n in enumerate(lengths) if n == 0)
    ok = ok_rows and zero_ok and torch.isfinite(o).all().item()
    log(f"[kernels] decode B={b} cap={cap} H={h} Hkv={hkv} D={d} "
        f"lengths={lengths}: max|o-plain|={err:.3e} worst (slot, head) "
        f"|o-plain|/max|plain row|={worst:.3e} (tol {TOL_OUT}) "
        f"zeros_for_len0={zero_ok} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"decode kernel disagrees with its plain version "
                         f"at B={b} H={h} Hkv={hkv} D={d}")
    return q, kc, vc, lens, err, worst


def phase_kernels():
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    da = importlib.import_module("paddle_tpu_torch.ops.decode_attention")
    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    records = {}

    # flash: gpt3-1.3b prefill shapes (B=1, H=16, D=128) at buckets and a
    # ragged length, GQA, D=64, a key mask and full attention
    worst = []
    for s in (16, 48, 128, 2048):
        q, k, v, err, w = check_flash(gen, 1, s, 16, 16, 128)
        worst.append(w)
    worst += [check_flash(gen, 1, 256, 16, 4, 128)[-1],
              check_flash(gen, 2, 192, 8, 8, 64)[-1],
              check_flash(gen, 2, 200, 16, 4, 128, causal=False,
                          mask=True)[-1]]
    b, s, h, d = q.shape
    t_kernel = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    t_plain = cuda_ms(lambda: fa._flash_plain(q, k, v, True), iters=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    t_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    flops = 4 * b * h * d * (s * (s + 1) // 2)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) + 4 * b * h * s
    b_ms, b_by = bound(flops, nbytes)
    log(f"[kernels] flash timing B={b} S={s} H={h} D={d} causal: "
        f"kernel_ms={t_kernel:.4f} plain_ms={t_plain:.4f} "
        f"library_ms={t_lib:.4f} bound_ms={b_ms:.4f} ({b_by}, "
        f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)")
    records["flash_fwd"] = dict(
        name="flash_fwd", route="cuda",
        source="paddle_tpu_torch/csrc/flash_fwd.cu",
        replaces="paddle_tpu/ops/flash_attention.py:72",
        max_abs_err=err, max_row_rel_err=max(worst), row_tol=TOL_OUT,
        ms=t_kernel, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=t_lib)
    for s2 in (128, 512):
        q2, k2, v2 = (x[:, :s2].contiguous() for x in (q, k, v))
        t2 = cuda_ms(lambda: fa.flash_attention_fwd(q2, k2, v2, causal=True))
        log(f"[kernels] flash timing S={s2}: kernel_ms={t2:.4f}")

    # decode: batch_slots=8 over the 2048-token cache, boundary lengths
    mixed = [0, 1, 127, 128, 1000, 2048, 64, 1537]
    err, w = check_decode(gen, mixed, 2048, 16, 16, 128)[-2:]
    worst = [w, check_decode(gen, mixed, 2048, 16, 4, 128)[-1],
             check_decode(gen, [0, 5, 300, 512], 512, 8, 8, 64)[-1]]
    full = [2048] * 8
    q, kc, vc, lens, err_full, w = check_decode(gen, full, 2048, 16, 16, 128)
    worst.append(w)
    t_kernel = cuda_ms(lambda: da.decode_attention(q, kc, vc, lens), iters=50)
    t_plain = cuda_ms(lambda: da._decode_plain(q, kc, vc, lens), iters=5)
    b, h, d = q.shape
    qt = q[:, :, None].contiguous()
    kt, vt = (x.transpose(1, 2).contiguous() for x in (kc, vc))
    keep = (torch.arange(kc.shape[1], device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    t_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=keep), iters=50)
    npos = sum(full)
    hkv = kc.shape[2]
    flops = 4 * h * d * npos
    nbytes = 2 * 2 * npos * hkv * d + 2 * 2 * q.numel() + 4 * b
    b_ms, b_by = bound(flops, nbytes)
    log(f"[kernels] decode timing B={b} lengths=8x2048 H={h} D={d}: "
        f"kernel_ms={t_kernel:.4f} plain_ms={t_plain:.4f} "
        f"library_ms={t_lib:.4f} bound_ms={b_ms:.4f} ({b_by}, "
        f"{nbytes / 1e6:.2f} MB)")
    records["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="paddle_tpu_torch/csrc/decode_attention.cu",
        replaces="paddle_tpu/ops/decode_attention.py:126",
        max_abs_err=max(err, err_full), max_row_rel_err=max(worst),
        row_tol=TOL_OUT, ms=t_kernel, plain_ms=t_plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=t_lib)
    return records


def check_bwd(gen, b, s, h, hkv, d, causal=True, mask=False):
    """The dq and dk/dv kernels against the plain backward on the same
    bf16 inputs and the forward kernel's own o and lse, per row; each
    kernel runs twice and must give bitwise-equal results (no atomics).
    Returns the inputs and ``{kernel: (max abs error, worst row ratio)}``."""
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    q = _rand((b, s, h, d), gen)
    k = _rand((b, s, hkv, d), gen)
    v = _rand((b, s, hkv, d), gen)
    do = _rand((b, s, h, d), gen)
    kv_mask = None
    if mask:
        kv_mask = (torch.rand((b, s), generator=gen, device="cuda") > 0.3
                   ).float()
        kv_mask[-1, 0] = 0.0     # causal query 0 of the last row: no key
    o, lse = fa._flash_cuda(q, k, v, causal, kv_mask)
    got = fa._flash_bwd_cuda(q, k, v, o, lse, do, causal, kv_mask)
    again = fa._flash_bwd_cuda(q, k, v, o, lse, do, causal, kv_mask)
    ref = fa._flash_bwd_plain(q.float(), k.float(), v.float(), o.float(),
                              lse, do.float(), causal, kv_mask)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    res = {n: row_errors(g, r, TOL_BWD, BWD_FLOOR)
           for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
    finite = all(torch.isfinite(g).all().item() for g in got)
    ok = same and finite and all(r[2] for r in res.values())
    log(f"[train-kernels] flash bwd B={b} S={s} H={h} Hkv={hkv} D={d} "
        f"causal={causal} mask={mask}: " + " ".join(
            f"max|{n}-plain|={r[0]:.3e} worst row {r[1]:.3e}"
            for n, r in res.items()) +
        f" (tol {TOL_BWD} per row) deterministic={same} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"flash backward kernels disagree with the plain "
                         f"version at B={b} S={s} H={h} Hkv={hkv} D={d}")
    errs = {"flash_bwd_dq": res["dq"][:2],
            "flash_bwd_dkv": (max(res["dk"][0], res["dv"][0]),
                              max(res["dk"][1], res["dv"][1]))}
    return (q, k, v, o, lse, do), errs


def phase_train_kernels(records):
    """The backward kernels at the training shape and the edge shapes,
    then timed at the training shape."""
    from paddle_tpu_torch.ops import _build
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    worst = {"flash_bwd_dq": [], "flash_bwd_dkv": []}
    cases = [(1, 48, 16, 16, 128, True, False),
             (2, 200, 16, 16, 128, True, False),
             (2, 256, 16, 4, 128, True, False),
             (2, 192, 8, 8, 64, True, False),
             (2, 200, 16, 4, 128, True, True),
             (2, 130, 4, 2, 64, False, True),
             (4, 2048, 16, 16, 128, True, False)]     # the training shape
    for case in cases:
        tensors, errs = check_bwd(gen, *case[:5], causal=case[5],
                                  mask=case[6])
        for key, e in errs.items():
            worst[key].append(e)
    q, k, v, o, lse, do = tensors
    b, s, h, d = q.shape
    hkv = k.shape[2]
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    args = [_build.ptr(x) for x in (q, k, v, do, lse, delta)] + \
        [_build.ptr(None)]
    dims = (b, s, h, hkv, d, 1, _build.DTYPE_CODES[q.dtype],
            _build.stream_ptr(q))
    t_dq = cuda_ms(lambda: fa.FLASH_BWD_DQ(*args, _build.ptr(dq), *dims))
    t_dkv = cuda_ms(lambda: fa.FLASH_BWD_DKV(*args, _build.ptr(dk),
                                             _build.ptr(dv), *dims))
    t_fwd = cuda_ms(lambda: fa._flash_cuda(q, k, v, True, None))
    t_plain = cuda_ms(lambda: fa._flash_bwd_plain(q, k, v, o, lse, do, True),
                      iters=3, warmup=1)
    # yardstick: the library's attention backward (dq, dk and dv in one
    # call) = forward + autograd.grad minus the forward alone
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def lib_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    t_lib = cuda_ms(lambda: torch.autograd.grad(lib_fwd(), (qt, kt, vt),
                                                dot)) - cuda_ms(lib_fwd)
    pairs = b * h * (s * (s + 1) // 2)          # causal (query, key) pairs
    row_bytes = 2 * b * h * s * 4               # lse and delta, f32
    dq_flops = 3 * 2 * d * pairs
    dq_bytes = 2 * (2 * q.numel() + 2 * k.numel() + do.numel()) + row_bytes
    dkv_flops = 4 * 2 * d * pairs
    dkv_bytes = 2 * (q.numel() + 4 * k.numel() + do.numel()) + row_bytes
    for key, t, flops, nbytes, line in (
            ("flash_bwd_dq", t_dq, dq_flops, dq_bytes, 133),
            ("flash_bwd_dkv", t_dkv, dkv_flops, dkv_bytes, 183)):
        b_ms, b_by = bound(flops, nbytes)
        log(f"[train-kernels] {key} timing B={b} S={s} H={h} D={d} causal: "
            f"kernel_ms={t:.4f} bound_ms={b_ms:.4f} ({b_by}, "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)")
        records[key] = dict(
            name=key, route="cuda",
            source=f"paddle_tpu_torch/csrc/{key}.cu",
            replaces=f"paddle_tpu/ops/flash_attention.py:{line}",
            max_abs_err=max(e[0] for e in worst[key]),
            max_row_rel_err=max(e[1] for e in worst[key]), row_tol=TOL_BWD,
            ms=t, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
            library_ms=t_lib,
            note="plain_ms and library_ms each compute dq, dk and dv "
                 "together: the plain backward, and "
                 "scaled_dot_product_attention's backward (forward + "
                 "autograd.grad minus the forward)")
    fwd_ms, _ = bound(2 * 2 * d * pairs, 2 * 4 * q.numel() + 4 * b * h * s)
    log(f"[train-kernels] backward at the training shape: dq + dk/dv "
        f"{t_dq + t_dkv:.4f} ms (plain {t_plain:.4f} ms, library backward "
        f"{t_lib:.4f} ms); forward kernel {t_fwd:.4f} ms "
        f"(bound {fwd_ms:.4f} ms)")
    phase_fused_ce(gen)


def phase_fused_ce(gen):
    """The blocked cross-entropy of the train step (N = 4 x 2048 rows,
    hidden 2048, vocab 50304, bf16 operands as under AMP) against the
    full f32 logits, and its time."""
    tce = importlib.import_module("paddle_tpu_torch.ops.fused_cross_entropy")
    n, hd, vocab = 4 * 2048, 2048, 50304
    hidden = _rand((n, hd), gen)
    weight = (torch.randn((vocab, hd), generator=gen, device="cuda")
              * 0.02).bfloat16()
    labels = torch.randint(0, vocab, (n,), generator=gen, device="cuda")
    labels[::7] = -100
    g = torch.rand(n, generator=gen, device="cuda")
    h1, w1 = hidden.clone().requires_grad_(), weight.clone().requires_grad_()
    loss = tce.fused_linear_cross_entropy(h1, w1, labels, reduction="none")
    (loss * g).sum().backward()
    # reference: full logits in f32 (no TF32), autograd
    h2 = hidden.float().requires_grad_()
    w2 = weight.float().requires_grad_()
    ref = torch.nn.functional.cross_entropy(h2 @ w2.t(), labels,
                                            ignore_index=-100,
                                            reduction="none")
    (ref * g).sum().backward()
    torch.cuda.synchronize()
    loss_err = ((loss - ref).abs() / ref.abs().clamp_min(1.0)).max().item()
    gerr = [((a.grad.float() - r.grad).abs().max() / r.grad.abs().max()
             ).item() for a, r in ((h1, h2), (w1, w2))]
    ok = loss_err <= TOL_CE_LOSS and max(gerr) <= TOL_CE_GRAD
    del h2, w2, ref
    fwd_ms = cuda_ms(lambda: tce.fused_linear_cross_entropy(hidden, weight,
                                                            labels),
                     iters=5, warmup=1)

    def fwd_bwd():
        tce.fused_linear_cross_entropy(h1, w1, labels).backward()

    both_ms = cuda_ms(fwd_bwd, iters=5, warmup=1)
    log(f"[train-kernels] fused CE N={n} H={hd} V={vocab} bf16 operands, "
        f"TF32 products: loss worst row {loss_err:.3e} (tol {TOL_CE_LOSS}), "
        f"d(hidden) {gerr[0]:.3e}, d(weight) {gerr[1]:.3e} of max "
        f"(tol {TOL_CE_GRAD}); forward_ms={fwd_ms:.3f} "
        f"forward+backward_ms={both_ms:.3f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("fused cross-entropy disagrees with full logits")


def build_model():
    from paddle_tpu_torch.core import random as prandom
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_configs
    cfg = gpt_configs()["gpt3-1.3b"]
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=prandom.seed(1234, "cuda"))
    model.eval()
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    log(f"[serve] gpt3-1.3b: {n / 1e9:.3f} B params bf16, hidden "
        f"{cfg.hidden_size}, {cfg.num_layers} layers, {cfg.num_heads} heads, "
        f"max_seq_len {cfg.max_seq_len}, init {time.perf_counter() - t0:.2f} s")
    return model


def phase_serve(model):
    from paddle_tpu_torch.inference import InferenceEngine
    from paddle_tpu_torch.ops import KERNELS
    cfg = model.cfg
    # warm the libraries (cuBLAS handles, allocator) off the record
    scratch = model.init_kv_cache(1)
    model.prefill(torch.zeros((1, 64), dtype=torch.long, device="cuda"),
                  scratch, 0, 64)
    model.decode_step(torch.zeros(1, dtype=torch.long, device="cuda"),
                      scratch, torch.ones(1, dtype=torch.int32, device="cuda"))
    del scratch
    torch.cuda.synchronize()

    rng = np.random.RandomState(7)
    n_req, new_tokens = 16, 32
    plens = rng.randint(32, 1537, size=n_req)
    plens[:4] = [32, 100, 700, 1536]        # at least four buckets
    eng = InferenceEngine(model, batch_slots=8, top_k=50, seed=7,
                          device="cuda")
    rids = {}
    for i, n in enumerate(plens):
        sampled = i % 5 == 4
        rid = eng.add_request(rng.randint(0, cfg.vocab_size, size=int(n)),
                              max_new_tokens=new_tokens,
                              temperature=0.8 if sampled else 0.0,
                              top_p=0.9 if sampled else 1.0)
        rids[rid] = int(n)
    torch.cuda.reset_peak_memory_stats()
    for kernel in KERNELS.values():
        kernel.launches = 0
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in KERNELS.values()}
    st = eng.stats()
    counts = [len(results[r]) for r in rids]
    finite = bool(torch.isfinite(eng.cache.k).all().item()
                  and torch.isfinite(eng.cache.v).all().item())
    tokens = sum(counts)
    log(f"[serve] {n_req} requests, prompt lengths {sorted(rids.values())}, "
        f"buckets used {sorted(st['prefill_ms_by_bucket'])}")
    log(f"[serve] tokens={tokens} wall_s={wall:.3f} "
        f"tokens_per_s={tokens / wall:.1f} prefills={st['prefills']} "
        f"decode_steps={st['decode_steps']} "
        f"mean_decode_step_ms={st['decode_ms'] / st['decode_steps']:.3f} "
        f"decode_tokens_per_s={st['decode_tokens_per_sec']:.1f}")
    for bk, v in st["prefill_ms_by_bucket"].items():
        log(f"[serve] prefill bucket {bk}: n={v['count']} "
            f"mean_ms={v['mean_ms']:.3f}")
    log(f"[serve] max_memory_allocated={torch.cuda.max_memory_allocated()} "
        f"bytes; host_syncs decode={st['decode_host_syncs']} "
        f"prefill={st['prefill_host_syncs']}; launches {launches}")
    layers = cfg.num_layers
    problems = []
    if counts != [new_tokens] * n_req:
        problems.append(f"token counts {counts} != {new_tokens} each")
    if not finite:
        problems.append("non-finite values in the KV cache")
    if launches["flash_fwd"] != layers * st["prefills"]:
        problems.append(f"flash launches {launches['flash_fwd']} != "
                        f"{layers} x {st['prefills']} prefills")
    if launches["decode_attention"] != layers * st["decode_steps"]:
        problems.append(f"decode launches {launches['decode_attention']} != "
                        f"{layers} x {st['decode_steps']} decode steps")
    if st["decode_host_syncs"] != st["decode_steps"]:
        problems.append(f"{st['decode_host_syncs']} host syncs over "
                        f"{st['decode_steps']} decode steps")
    if problems:
        raise SystemExit("serve phase failed: " + "; ".join(problems))
    log("[serve] ok")
    return launches


def phase_teacher_forced(model):
    cfg = model.cfg
    rng = np.random.RandomState(11)
    plen, steps = 200, 8
    ids = torch.from_numpy(
        rng.randint(0, cfg.vocab_size, size=(1, plen + steps))).cuda()
    with torch.no_grad():
        ref = model(ids).float()                       # [1, S, V]
        cache = model.init_kv_cache(1)
        padded = torch.zeros((1, 256), dtype=torch.long, device="cuda")
        padded[:, :plen] = ids[:, :plen]
        got = [model.prefill(padded, cache, 0, plen)[0].float()]
        one = torch.ones(1, dtype=torch.int32, device="cuda")
        for t in range(plen, plen + steps - 1):
            got.append(model.decode_step(ids[:, t], cache, one)[0].float())
    got = torch.cat(got)                                # [steps, V]
    want = ref[0, plen - 1:plen + steps - 1]
    # per position: each row of logits against its own largest |logit|
    err = (got - want).abs().amax(-1)
    scale = want.abs().amax(-1)
    worst = (err / scale).max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    ok = bool(torch.isfinite(got).all().item()) and worst <= TOL_TEACHER
    log(f"[teacher] prefill({plen}, bucket 256) + {steps - 1} decode steps vs "
        f"forward({plen + steps}): max|diff|={err.max().item():.4e}, worst "
        f"position max|diff|/max|logit|={worst:.4e} (tol {TOL_TEACHER}) "
        f"argmax agreement {agree:.3f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("teacher-forced check failed")


def phase_profile(model):
    """Where a steady decode step's time goes: 8 active slots with
    512-token prompts; 5 steps timed on the host clock (each step ends in
    its host sync, so that is the step's real duration), then 5 steps
    under torch.profiler for the device kernel time per step."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference import InferenceEngine
    eng = InferenceEngine(model, batch_slots=8, device="cuda")
    rng = np.random.RandomState(13)
    for _ in range(8):
        eng.add_request(rng.randint(0, model.cfg.vocab_size, size=512),
                        max_new_tokens=16)
    for _ in range(3):          # admissions, then two warm decode steps
        eng.step()
    steps = 5
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
    report_profile(prof, steps, wall_ms,
                   "decode step (8 active, ~520-token slots)")


def report_profile(prof, steps, wall_ms, what):
    """Device kernel time per step (torch.profiler) against the step's
    wall time from unprofiled steps, and the top kernels."""
    from torch.autograd import DeviceType
    rows = sorted(
        ((e.self_device_time_total / steps / 1e3, e.count // steps, e.key)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms == 0:
        log(f"[profile] {what}: wall {wall_ms:.3f} ms; device time not "
            f"visible to torch.profiler, busy share not measured")
        return
    log(f"[profile] {what}: wall {wall_ms:.3f} ms, device kernels "
        f"{busy_ms:.3f} ms (busy share {busy_ms / wall_ms:.3f}, idle share "
        f"{1 - busy_ms / wall_ms:.3f}), {sum(r[1] for r in rows)} kernel "
        f"launches per step")
    groups = {}
    for ms, n, key in rows:
        if "flash_" in key or "decode_kernel" in key:
            group = "port kernels"
        elif any(w in key for w in ("nvjet", "gemm", "cutlass", "xmma")):
            group = "library matmuls"
        elif any(w in key for w in ("elementwise", "copy", "Functor")):
            group = "elementwise and casts"
        else:
            group = "other"
        groups[group] = groups.get(group, 0.0) + ms
    log("[profile]   by group: " + ", ".join(
        f"{g} {ms:.3f} ms" for g, ms in sorted(groups.items(),
                                              key=lambda x: -x[1])))
    for ms, n, key in rows[:10]:
        log(f"[profile]   {ms:.4f} ms/step  x{n}  {key[:90]}")


def make_trainer(cfg, seed, optimizer):
    """A gpt3-1.3b-width model with f32 masters (random weights from
    ``seed``) behind ``SpmdTrainer`` with bf16 AMP, as the JAX package's
    bench.py sets it up."""
    from paddle_tpu_torch.core import random as prandom
    from paddle_tpu_torch.distributed import SpmdTrainer
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32,
                           generator=prandom.seed(seed, "cuda"))
    st = DistributedStrategy()
    st.amp = True
    crit = GPTPretrainingCriterion()
    return model, SpmdTrainer(model, optimizer, lambda o, lab: crit(o, lab),
                              strategy=st, anomaly_policy="raise")


def token_batch(rng, vocab, b, s):
    """Random token ids and the next-token labels (bench.py's data)."""
    ids = rng.randint(0, vocab, (b, s)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1).astype(np.int32)


def phase_train_parity():
    """Every parameter gradient of one AMP step through the kernels
    against the same step with the plain attention swapped in here (the
    package has no switch for it).  SGD at learning rate 0 leaves the
    weights as they were, so both steps start from the same state."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import gpt_configs
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    cfg = gpt_configs()["gpt3-1.3b"]
    cfg.num_layers, cfg.fused_ce = 2, True
    model, trainer = make_trainer(cfg, 99, topt.SGD(learning_rate=0.0))
    ids, labels = token_batch(np.random.RandomState(21), cfg.vocab_size, 2,
                              512)

    def step():
        n_bwd = fa.FLASH_BWD_DQ.launches
        loss = float(trainer.train_step(ids, labels))
        grads = {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()}
        return loss, grads, fa.FLASH_BWD_DQ.launches - n_bwd

    loss_k, grads_k, launched = step()
    saved = fa._fwd, fa._bwd
    fa._fwd, fa._bwd = fa._flash_plain, fa._flash_bwd_plain
    try:
        loss_p, grads_p, launched_plain = step()
    finally:
        fa._fwd, fa._bwd = saved
    ratios = {n: ((grads_k[n] - grads_p[n]).abs().max()
                  / grads_p[n].abs().max().clamp_min(1e-30)).item()
              for n in grads_k}
    worst = max(ratios, key=ratios.get)
    ok = (launched == cfg.num_layers and launched_plain == 0
          and all(r <= TOL_GRAD for r in ratios.values())
          and np.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-2)
    log(f"[train-parity] gpt3-1.3b width, {cfg.num_layers} layers, bf16 AMP, "
        f"batch 2 x 512: loss kernels {loss_k:.6f} plain {loss_p:.6f}; "
        f"{len(ratios)} gradients, worst max|diff|/max|plain| "
        f"{ratios[worst]:.3e} ({worst}), median "
        f"{float(np.median(list(ratios.values()))):.3e} (tol {TOL_GRAD}); "
        f"dq launches kernel step {launched}, plain step {launched_plain} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("train-parity failed")


def phase_train():
    """The gpt3-1.3b training step at full width and depth; returns the
    launch counts of its measured window."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import async_dispatch
    from paddle_tpu_torch.io import DevicePrefetcher
    from paddle_tpu_torch.models import gpt_configs
    from paddle_tpu_torch.ops import KERNELS
    cfg = gpt_configs()["gpt3-1.3b"]
    cfg.fused_ce = True
    b, s, n_warm, n_meas = 4, 2048, 2, 6
    t0 = time.perf_counter()
    model, trainer = make_trainer(cfg, 4321, topt.Adam(learning_rate=1e-4))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[train] gpt3-1.3b: {n_params / 1e9:.3f} B params f32, bf16 AMP, "
        f"fused CE, Adam lr 1e-4, batch {b} x {s}, init "
        f"{time.perf_counter() - t0:.2f} s")
    batch = token_batch(np.random.RandomState(0), cfg.vocab_size, b, s)
    feed = DevicePrefetcher(itertools.repeat(batch, n_warm + n_meas),
                            device="cuda", timings=trainer._timings)
    results = []
    for i, (ids, labels) in enumerate(feed):
        if i == n_warm:                  # the measured window starts
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for kernel in KERNELS.values():
                kernel.launches = 0
            async_dispatch.reset_host_sync_count()
            t0 = time.perf_counter()
        results.append(trainer.train_step(ids, labels))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in KERNELS.values()}
    syncs = async_dispatch.host_sync_count()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(r) for r in results]
    step_ms = wall * 1e3 / n_meas
    tokens_s = n_meas * b * s / wall
    mfu = cfg.flops_per_token(s) * tokens_s / PEAK_BF16_FLOPS
    masters_f32 = all(p.dtype == torch.float32 for p in model.parameters())
    log(f"[train] losses {[round(x, 4) for x in losses]} (first {n_warm} "
        f"warm-up)")
    log(f"[train] {n_meas} steps in {wall:.3f} s: step_ms={step_ms:.3f} "
        f"tokens_per_s={tokens_s:.1f} MFU={mfu:.4f} (flops_per_token "
        f"{cfg.flops_per_token(s):.4e} x tokens/s over "
        f"{PEAK_BF16_FLOPS:.3e}) max_memory_allocated={peak} bytes "
        f"host_syncs={syncs} launches {launches}")
    log(f"[train] stats {trainer.stats}")
    layers = cfg.num_layers
    problems = []
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        problems.append(f"losses not finite and falling: {losses}")
    if syncs != 0:
        problems.append(f"{syncs} host syncs in the measured steps")
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if launches[key] != layers * n_meas:
            problems.append(f"{key} launches {launches[key]} != "
                            f"{layers} x {n_meas}")
    if not masters_f32:
        problems.append("master parameters are no longer f32")
    if problems:
        raise SystemExit("train phase failed: " + "; ".join(problems))

    # one profiled step: device time against the measured step time
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(ids, labels)
        torch.cuda.synchronize()
    report_profile(prof, 1, step_ms, "train step (gpt3-1.3b, 4 x 2048)")

    # recompute: two steps from one saved state without and with it
    params = dict(model.named_parameters())
    snap_p = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
    snap_o = {k: v.to("cpu", copy=True) if torch.is_tensor(v) else v
              for k, v in trainer.optimizer.state_dict().items()}

    def two_steps():
        for kernel in KERNELS.values():
            kernel.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = [trainer.train_step(ids, labels) for _ in range(2)]
        torch.cuda.synchronize()
        return ([float(r) for r in out],
                torch.cuda.max_memory_allocated() - base,
                KERNELS["flash_fwd.cu"].launches)

    plain, plain_peak, _ = two_steps()
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(snap_p[n])
    trainer.optimizer.set_state_dict(
        {k: v.to("cuda") if torch.is_tensor(v) else v
         for k, v in snap_o.items()})
    del snap_p, snap_o
    model.enable_recompute()
    rec, rec_peak, rec_fwd = two_steps()
    diff = max(abs(x - y) / abs(y) for x, y in zip(rec, plain))
    ok = (rec_fwd == 2 * layers * 2 and diff <= TOL_RECOMPUTE
          and rec_peak < plain_peak)
    log(f"[train] recompute: losses {rec} vs {plain} without (worst "
        f"relative diff {diff:.3e}, tol {TOL_RECOMPUTE}); flash_fwd launches "
        f"{rec_fwd} over 2 steps; peak above the resident state "
        f"{rec_peak} vs {plain_peak} bytes without {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("recompute check failed")
    log("[train] ok")
    return launches


def main():
    name, count, _ = phase_device()
    t0 = time.perf_counter()
    phase_build()
    records = phase_kernels()
    phase_train_kernels(records)
    model = build_model()
    serve = phase_serve(model)
    phase_teacher_forced(model)
    phase_profile(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_parity()
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train()
    for key, rec in records.items():
        by_path = {p: n[key] for p, n in (("serve", serve), ("train", train))
                   if n[key]}
        rec["launches"] = sum(by_path.values())
        rec["launches_by_path"] = by_path
    log(f"[done] {time.perf_counter() - t0:.1f} s after the device check")
    keys = ["name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "max_row_rel_err", "row_tol",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys}, **({"note": r["note"]} if "note" in r
                                       else {})}
        for r in records.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


if __name__ == "__main__":
    main()
