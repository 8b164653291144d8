"""End-to-end check of paddle_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero
before the result lines:

1. device: CUDA device name, count and ``nvidia-smi`` name/power limit
   (no CUDA device: exit 2);
2. build: every ``paddle_tpu_torch/csrc/*.cu`` compiled by nvcc, all in
   parallel, with the compiler's register and spill report;
3. kernels: each hand-written kernel against its plain PyTorch version
   on the card at the serving path's shapes (bf16), with the stated
   tolerance, then timed (CUDA events) beside the plain version, one
   PyTorch library call computing the same function (a yardstick the
   port never calls) and the least time the card could take;
4. serve: gpt3-1.3b in bf16 (random weights from a seed, full width and
   depth) behind ``InferenceEngine(batch_slots=8)``, 16 requests of 32
   new tokens; checks token counts, finite cache contents, one host sync
   per decode step, and that every prefill/decode layer launched the
   kernels (launch counts reset just before the run, read just after);
5. teacher-forced: prefill + 8 decode steps reproduce ``model.forward``
   over the same tokens within the stated bf16 tolerance;
6. profile: device time against wall time of steady decode steps
   (torch.profiler), the top kernels by device time.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import importlib
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


def row_errors(got, ref):
    """Rows along the last axis: (max abs error, worst row's error over
    that row's max |ref|, whether every row is within TOL_OUT of its own
    scale).  A row whose reference is all zeros must come out exactly 0."""
    err = (got.float() - ref).abs().amax(-1)
    scale = ref.abs().amax(-1)
    ok = bool((err <= TOL_OUT * scale).all().item())
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
    from torch.autograd import DeviceType
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
    rows = sorted(
        ((e.self_device_time_total / steps / 1e3, e.count // steps, e.key)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms == 0:
        log(f"[profile] decode step wall {wall_ms:.3f} ms; device time not "
            f"visible to torch.profiler, busy share not measured")
        return
    log(f"[profile] decode step (8 active, ~520-token slots): wall "
        f"{wall_ms:.3f} ms, device kernels {busy_ms:.3f} ms "
        f"(busy share {busy_ms / wall_ms:.3f}, idle share "
        f"{1 - busy_ms / wall_ms:.3f}), {sum(r[1] for r in rows)} kernel "
        f"launches per step")
    for ms, n, key in rows[:8]:
        log(f"[profile]   {ms:.4f} ms/step  x{n}  {key[:90]}")


def main():
    name, count, _ = phase_device()
    t0 = time.perf_counter()
    phase_build()
    records = phase_kernels()
    model = build_model()
    launches = phase_serve(model)
    phase_teacher_forced(model)
    phase_profile(model)
    for key, rec in records.items():
        rec["launches"] = launches[key]
    log(f"[done] {time.perf_counter() - t0:.1f} s after the device check")
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "max_row_rel_err", "row_tol", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in records.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


if __name__ == "__main__":
    main()
