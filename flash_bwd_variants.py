"""Variants of the flash-backward kernels, timed against the committed ones
on one NVIDIA GPU.

    python3 flash_bwd_variants.py

Each variant is the committed source (``paddle_tpu_torch/csrc/
flash_bwd_dq.cu`` or ``flash_bwd_dkv.cu``) with one edit made here,
compiled alone with the package's nvcc flags into ``build/variants/``.
Every variant is first run at a few shapes against the plain backward
(the per-row check of ``chip_smoke.py``; the variants that drop work are
expected to fail it), then all are timed at the training shape (B=4,
S=2048, H=16, D=128, causal) in turns, forward and backward order
alternating, three rounds, best round reported.  What they show:

- ``dq:consumers2``: the dq kernel with two consumer warpgroups (a
  128-row tile, 240 registers a thread) in place of three;
- ``dkv:stages2`` / ``dkv:stages4``: the dk/dv ring two or four deep in
  place of three;
- ``dkv:no_softmax`` / ``dkv:no_scores`` / ``dkv:no_grads``: dk/dv
  without the exponentials, without the two score products (s^T, dp^T)
  or without the two gradient products (dv, dk): what each part of the
  work costs (wrong results, timing only).

Needs nvcc and one CUDA device; exits non-zero without them.
"""
from __future__ import annotations

import ctypes
import importlib
import os
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "variants"


def _edit(text, old, new):
    if old not in text:
        raise SystemExit(f"variant edit no longer applies: {old[:60]!r}")
    return text.replace(old, new)


def _no_scores(text):
    a = text.index("          float st[32], dpt[32];")
    b = text.index("          hopper::fence_regs<32>(dpt);") + len(
        "          hopper::fence_regs<32>(dpt);")
    return text[:a] + """          float st[32], dpt[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.01f * i;
          hopper::fence_regs<32>(st);
          hopper::fence_regs<32>(dpt);""" + text[b:]


def _no_grads(text):
    a = text.index("          // dv += p^T (64 keys x 64 queries)")
    end = "          hopper::fence_regs<D / 2>(dk_acc);"
    b = text.index(end) + len(end)
    return text[:a] + """          asm volatile("" ::"r"(pa[0][0]), "r"(da[3][3]));""" + text[b:]


VARIANTS = {
    "dq:consumers2": ("flash_bwd_dq.cu", lambda t: _edit(
        t, "constexpr int kConsumers = 3;", "constexpr int kConsumers = 2;")),
    "dkv:stages2": ("flash_bwd_dkv.cu", lambda t: _edit(
        t, "constexpr int kStages = 3;", "constexpr int kStages = 2;")),
    "dkv:stages4": ("flash_bwd_dkv.cu", lambda t: _edit(
        t, "constexpr int kStages = 3;", "constexpr int kStages = 4;")),
    "dkv:no_softmax": ("flash_bwd_dkv.cu", lambda t: _edit(
        t, "p = hopper::ex2(fmaf(st[i], scale_l2, -lc));", "p = st[i];")),
    "dkv:no_scores": ("flash_bwd_dkv.cu", _no_scores),
    "dkv:no_grads": ("flash_bwd_dkv.cu", _no_grads),
}


def build(_build):
    """Compile the committed sources and every variant, all at once;
    returns {name: C function}."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {"dq:committed": _build.CSRC / "flash_bwd_dq.cu",
            "dkv:committed": _build.CSRC / "flash_bwd_dkv.cu"}
    for name, (source, edit) in VARIANTS.items():
        path = OUT / (name.replace(":", "_") + ".cu")
        path.write_text(edit((_build.CSRC / source).read_text()))
        jobs[name] = path
    procs = {}
    for name, path in jobs.items():
        lib = OUT / (name.replace(":", "_") + ".so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(lib), str(path)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if "spill" in ln and " 0 bytes spill stores" not in ln})
        cs.log(f"[variants] {name}: nvcc exit {proc.returncode}, spills: "
               f"{spills or 'none'}")
        if proc.returncode:
            raise SystemExit(log)
        fn = getattr(ctypes.CDLL(str(lib)), "flash_bwd_dq" if
                     name.startswith("dq") else "flash_bwd_dkv")
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    cs.phase_device()
    from paddle_tpu_torch.ops import _build
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    fns = build(_build)
    P = _build.ptr
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)

    def inputs(b, s, h, hkv, d, causal, mask):
        q, k, v, do = (cs._rand(sh, gen) for sh in (
            (b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d)))
        m = (torch.rand((b, s), generator=gen, device="cuda") > 0.3
             ).float() if mask else None
        o, lse = fa._flash_cuda(q, k, v, causal, m)
        delta = fa._flash_bwd_delta_plain(o.float(), do.float()).contiguous()
        return [q, k, v, o, lse, do, *(torch.empty_like(x) for x in
                                       (q, k, v)), delta, m]

    def run(name, t, causal):
        q, k, v, o, lse, do, dq, dk, dv, delta, m = t
        dims = (q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3],
                int(causal), _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q))
        if name.startswith("dq"):
            err = fns[name](P(q), P(k), P(v), P(o), P(do), P(lse), P(m),
                            P(dq), P(delta), *dims)
        else:
            err = fns[name](P(q), P(k), P(v), P(do), P(lse), P(delta), P(m),
                            P(dk), P(dv), *dims)
        if err:
            raise SystemExit(f"{name}: launch failed with cudaError {err}")

    for case in [(2, 200, 8, 2, 128, True, False),
                 (2, 192, 8, 8, 64, True, False),
                 (1, 333, 4, 4, 128, True, True)]:
        t = inputs(*case)
        ref = fa._flash_bwd_plain(*(x.float() for x in t[:4]), t[4],
                                  t[5].float(), case[5], t[10])
        for name in fns:
            run(name, t, case[5])
            torch.cuda.synchronize()
            pairs = [(t[6], ref[0])] if name.startswith("dq") else \
                [(t[7], ref[1]), (t[8], ref[2])]
            res = [cs.row_errors(g, r, cs.TOL_BWD, cs.BWD_FLOOR)
                   for g, r in pairs]
            cs.log(f"[variants] {name} B,S,H,Hkv,D,causal,mask={case}: worst "
                   f"row {max(r[1] for r in res):.3e} "
                   f"{'ok' if all(r[2] for r in res) else 'differs'}")
    t = inputs(4, 2048, 16, 16, 128, True, False)
    names = list(fns)
    times = {n: [] for n in names}
    for rnd in range(3):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            times[name].append(cs.cuda_ms(lambda: run(name, t, True),
                                          iters=50))
    for name in names:
        cs.log(f"[variants] {name} B=4 S=2048 H=16 D=128 causal: best "
               f"{min(times[name]):.4f} ms, rounds "
               f"{[round(x, 4) for x in times[name]]}")


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.path.insert(0, str(ROOT))
    main()
