"""int8 and fp8 (e4m3) quantized compute and KV-cache quantization
(counterpart of ``paddle_tpu/ops/quantized_matmul.py``).

Symmetric amax scaling at per-(position, head) granularity: each
``head_dim`` vector of a key or value gets one f32 scale
``max(amax, 1e-8) / qmax`` and is stored as codes: int8 (``qmax`` 127)
``clip(round(x / scale), -127, 127)`` (``torch.round`` rounds half to
even, as ``jnp.round`` does), or e4m3 (``qmax`` 448, ``torch.
float8_e4m3fn``) by a plain cast of ``x / scale``, round to nearest
even with no clip, as the JAX package's ``astype`` does.  The decode
kernels stream the codes and scales and dequantize in registers; the
composites dequantize first.

The matmul half: :func:`quantized_matmul` computes ``x @ w`` through
8-bit codes, activations scaled per row and weights per output column,
int8 sums exact in int32 and e4m3 sums in f32, rescaled in f32 as
``(acc * sx) * sw``;
:func:`fake_quant_matmul` is the training op of ``GPTConfig(quantize=
'int8')`` and ``strategy.qat`` (that forward, a straight-through
backward over the dequantized operands).  A CPU tensor runs the plain
version ``_qmm_plain``; a CUDA tensor runs the hand-written kernel
``csrc/quantized_matmul.cu`` or raises: at M <= 16 every SM streams a
share of the weight codes (split-K, ``_Part``), above it int8 wgmma
tiles on a TMA ring (``_qmm_plan``); both sum in exact int32.  e4m3
codes run the same two regimes in ``csrc/quantized_matmul_f8.cu``
(e4m3 tensor-core products, each 128-deep k-tile's sum added into f32
registers; split-K pieces added in piece order).  The kernels take the
weight codes transposed, ``[N, K]``: the 8-bit tensor core products
want both operands K-contiguous.  Weights are quantized on
every call, as the JAX package does.  The JAX module's backend probe
(``quantized_matmul_available``) has no counterpart here.

Tuning: the tuning table's op ``qmm_tiles`` (key ``(device_kind,
m_bucket, n, k, dtype)``, as in the JAX package) holds, for an int8
product above M = 16, the plan overrides ``{"bn": 128 | 256, "splits":
s}`` that ``_qmm_plan`` takes (tile width and k splits of the built
kernel), not the JAX package's TPU block sizes (a list, which the port
ignores).  ``get_qmm_tiles`` reads them (nearest tabled shape when the
exact one is missing); ``autotune_qmm_sweep`` times every plan the
built kernel takes for a shape on the card, checks each output equal to
the default plan's (int32 sums are exact, so any plan gives the same
bits) and records the fastest with provenance.  With
``PADDLE_TPU_TUNING=sweep`` the first int8 product of an untabled shape
runs the sweep.  A sweep that fails raises.

``'fp8'`` has no TPU kernel in the JAX package (it rides the composite
``_qmm_composite``); the card has e4m3 tensor cores, so here it gets its
own kernel like int8.
"""
from __future__ import annotations

import ctypes
import functools
import os
import threading
from typing import Optional

import torch

from . import _build

__all__ = ["QUANT_DTYPES", "kv_storage_dtype", "kv_quant_mode",
           "resolve_kv_quant", "quantize_channel", "quantize_kv",
           "dequantize_kv", "write_kv", "quantized_matmul",
           "fake_quant_matmul", "get_qmm_tiles", "autotune_qmm_sweep",
           "SWEEP_LOG", "QUANTIZED_MATMUL", "QUANTIZED_MATMUL_F8"]

QUANT_DTYPES = ("int8", "fp8")
_EPS = 1e-8


_STORAGE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
CODE_DTYPES = tuple(_STORAGE.values())


def _check_mode(dtype: str) -> str:
    if dtype not in QUANT_DTYPES:
        raise ValueError(f"quantize dtype must be one of {QUANT_DTYPES}, "
                         f"got {dtype!r}")
    return dtype


def _qmax(dtype: str) -> float:
    """Largest code of the mode: ±127 for int8, ±448 (the largest finite
    e4m3) for fp8."""
    return 127.0 if _check_mode(dtype) == "int8" else 448.0


def kv_storage_dtype(dtype: str) -> torch.dtype:
    """The storage dtype of a quantized KV cache."""
    return _STORAGE[_check_mode(dtype)]


def kv_quant_mode(storage_dtype: torch.dtype) -> str:
    """Inverse of :func:`kv_storage_dtype`."""
    for mode, dt in _STORAGE.items():
        if storage_dtype == dt:
            return mode
    raise ValueError(f"not a quantized KV storage dtype: {storage_dtype}")


def resolve_kv_quant(name: Optional[str] = None) -> Optional[str]:
    """Normalize a ``kv_dtype`` knob (argument, else the
    ``PADDLE_TPU_KV_DTYPE`` environment variable) to a quant mode, or
    None for the full-precision cache (the default)."""
    if name is None:
        name = os.environ.get("PADDLE_TPU_KV_DTYPE", "")
    name = str(name).strip().lower()
    if name in ("", "0", "none", "off", "dense", "fp32", "bf16",
                "bfloat16", "float32"):
        return None
    return _check_mode(name)


def _cast_q(x_scaled: torch.Tensor, dtype: str = "int8") -> torch.Tensor:
    """Scaled values -> codes: int8 rounds half to even and clips to
    ±127; e4m3 is a plain cast (round to nearest even), as JAX's."""
    if dtype == "int8":
        return torch.clamp(torch.round(x_scaled), -127.0,
                           127.0).to(torch.int8)
    return x_scaled.to(torch.float8_e4m3fn)


def quantize_channel(x: torch.Tensor, axis: int, dtype: str = "int8"):
    """Symmetric amax quantization per channel along ``axis`` (the axis
    reduced per channel).  Returns ``(q, scale)`` with ``scale``
    keepdims-shaped so ``q.float() * scale ≈ x``."""
    xf = x.float()
    amax = torch.clamp(xf.abs().amax(dim=axis, keepdim=True), min=_EPS)
    # a tensor divisor: on the card PyTorch multiplies by the reciprocal
    # of a scalar divisor, which can land one ulp off the quotient the CPU
    # and the JAX package compute
    scale = amax / torch.full_like(amax, _qmax(dtype))
    return _cast_q(xf / scale, dtype), scale


def quantize_kv(x: torch.Tensor, dtype: str = "int8"):
    """``x [..., head_dim]`` -> ``(q [..., head_dim] codes (int8 or
    e4m3), scale [...] f32)`` with ``q.float() * scale[..., None] ≈ x``."""
    q, scale = quantize_channel(x, axis=-1, dtype=dtype)
    return q, scale[..., 0]


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` (``scale`` without the trailing
    head_dim axis)."""
    return (q.float() * scale[..., None].float()).to(dtype)


def write_kv(k_dst, v_dst, ks_dst, vs_dst, index, k, v):
    """Store k/v ``[..., Hkv, D]`` at ``k_dst[index]``/``v_dst[index]``
    (in place), dense or paged: as they are, or as int8 / e4m3 codes (the
    cache's dtype) with their scales when the cache is quantized
    (``ks_dst`` not None)."""
    if ks_dst is None:
        k_dst[index] = k.to(k_dst.dtype)
        v_dst[index] = v.to(v_dst.dtype)
        return
    # k and v quantized together: one pass of the quantizer's small
    # elementwise kernels instead of two, on the per-step decode path
    codes, scales = quantize_kv(torch.stack([k, v]),
                                kv_quant_mode(k_dst.dtype))
    k_dst[index], ks_dst[index] = codes[0], scales[0]
    v_dst[index], vs_dst[index] = codes[1], scales[1]


def kv_zeros(shape, mode: Optional[str], dtype: torch.dtype, device):
    """Zeroed storage of a KV cache (dense or paged) of ``shape [...,
    Hkv, D]``: ``(k, v, None, None)`` in ``dtype``, or for a quant
    ``mode`` its codes and f32 scales ``shape[:-1]``."""
    if mode is None:
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device), None, None)
    codes = kv_storage_dtype(mode)
    return (torch.zeros(shape, dtype=codes, device=device),
            torch.zeros(shape, dtype=codes, device=device),
            torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            torch.zeros(shape[:-1], dtype=torch.float32, device=device))


# ---- quantized compute: 8-bit codes -> int32 (int8) or f32 (e4m3) sums
# -> f32 rescale -------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
QUANTIZED_MATMUL = _build.CudaKernel(
    "quantized_matmul.cu", "quantized_matmul", [_P] * 7 + [_I] * 9 + [_P])
QUANTIZED_MATMUL_F8 = _build.CudaKernel(
    "quantized_matmul_f8.cu", "quantized_matmul_f8",
    [_P] * 7 + [_I] * 9 + [_P])
_OUT_CODES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_BK = 128            # k bytes a unit or a stage
_STRIP = 64          # decode: output columns a unit
_DEC_WARPS = 4       # decode: consumer warps (int32 partials in their fragment order)
_DECODE_M = 16       # M at or below: the decode regime


def _qmm_plain(qx, qw, sx, sw, out_dtype):
    """The JAX ``_qmm_composite``: ``qx [M, K] @ qw [K, N]``, int8 codes
    in exact integer arithmetic (int64 on the CPU; float64 on the card,
    exact below 2^53), e4m3 codes in f32 (each product exact, the sum
    rounded as f32), then ``(acc.float() * sx) * sw`` in f32, cast to
    ``out_dtype``."""
    if qx.dtype == torch.float8_e4m3fn:
        acc = torch.matmul(qx.float(), qw.float())
    else:
        wide = torch.float64 if qx.is_cuda else torch.int64
        acc = torch.matmul(qx.to(wide), qw.to(wide))
    return (acc.float() * sx * sw).to(out_dtype)


class _Part:
    """The decode regime's split of a ``k x n`` product over ``blocks``
    (the kernel's ``qmm::Part``): unit ``t`` is k-tile ``t % nk`` (128
    bytes) of 64-column strip ``t // nk``; block ``b`` streams units
    ``[start(b), start(b + 1))``, so blocks differ by one unit at most.
    The pieces of a strip belong to blocks ``blk(s nk) .. blk(s nk + nk -
    1)``; block ``b``'s piece writes partial ``b - blk(s nk)``."""

    def __init__(self, n: int, k: int, blocks: int):
        self.nk = k // _BK
        self.strips = n // _STRIP
        self.total = self.strips * self.nk
        self.blocks = blocks

    def start(self, b: int) -> int:
        return b * self.total // self.blocks

    def blk(self, t: int) -> int:
        """The block whose run holds unit t."""
        return ((t + 1) * self.blocks - 1) // self.total

    def pieces(self, strip: int) -> int:
        return (self.blk(strip * self.nk + self.nk - 1)
                - self.blk(strip * self.nk) + 1)

    def max_pieces(self) -> int:
        return max(self.pieces(s) for s in range(self.strips))


def _decode_pieces(n: int, k: int, blocks: int):
    """Each block's pieces in the decode regime, ``[(strip, kt0, kt1,
    slot), ...]`` in the order it streams them: k-tiles ``[kt0, kt1)`` of
    ``strip``, whose partial goes to ``slot`` of that strip."""
    pt = _Part(n, k, blocks)
    out = []
    for b in range(blocks):
        pieces, t, t1 = [], pt.start(b), pt.start(b + 1)
        while t < t1:
            strip, kt = divmod(t, pt.nk)
            te = min(t1, (strip + 1) * pt.nk)
            pieces.append((strip, kt, kt + te - t, b - pt.blk(strip * pt.nk)))
            t = te
        out.append(pieces)
    return out


def _prefill_items(m: int, n: int, k: int, blocks: int, bn: int,
                   splits: int):
    """Each block's items in the prefill regime (the kernel's ``Item``),
    ``[(m0, n0, kt0, kt1, split), ...]``: output tile rows ``[m0, m0 +
    BM)`` x columns ``[n0, n0 + bn)``, k-tiles ``[kt0, kt1)``; item ``i``
    goes to block ``i % blocks``, m fastest, then n, splits innermost."""
    bm = 64 if m <= 64 else 128
    mt, nk = -(-m // bm), k // _BK
    items = mt * -(-n // bn) * splits
    out = [[] for _ in range(blocks)]
    for it in range(items):
        tile, split = divmod(it, splits)
        out[it % blocks].append(((tile % mt) * bm, (tile // mt) * bn,
                                 split * nk // splits,
                                 (split + 1) * nk // splits, split))
    return out


def _split_steps(bm: int) -> int:
    """k-tiles a split of a ``bm``-row tile at least: its int32 partial
    (written, then read by the last split) must stay small beside the
    stages it loads.  A 128 x 128 tile's 64 KB partial against 32 KB a
    stage: on an H100, splitting the gpt3-1.3b out product at M=512 (K =
    2048, 8 k-tiles a split) ran 15% slower than not, the down product
    (32 a split) about a quarter faster.  A 64-row tile streams weights
    (the bytes bound it) and splits down to 4."""
    return 4 if bm == 64 else 16


@functools.lru_cache(maxsize=None)
def _qmm_plan(m: int, n: int, k: int, sms: int, bn: Optional[int] = None,
              splits: Optional[int] = None) -> dict:
    """The launch plan of the kernel (``bn``, ``splits`` override the
    choice above M = 16): its regime, blocks, tile width, k splits, and the
    int32 of partials and counters it needs (cached: read it, do not
    change it).  Decode (M <= 16): one block per SM over the 64-column x
    128-byte units.  Prefill: tiles of 64 (M <= 64) or 128 rows x 256
    columns where those fill half the SMs and N divides, else 128; K split
    so that tiles x splits fill the SMs when the tiles fill less than half
    of them, every split at least ``_split_steps(bm)`` k-tiles."""
    if m <= _DECODE_M:
        pt = _Part(n, k, 1)
        blocks = min(pt.total, sms)
        pieces = _Part(n, k, blocks).max_pieces()
        nt = 1 if m <= 8 else 2
        multi = pieces > 1
        return dict(regime="decode", blocks=blocks, bn=_STRIP, splits=1,
                    pieces=pieces,
                    work_ints=(pt.strips * pieces * _DEC_WARPS * nt * 32 * 4
                               if multi else 0),
                    counters=pt.strips if multi else 0)
    bm = 64 if m <= 64 else 128
    mt, nk = -(-m // bm), k // _BK
    if bn is None:
        bn = 256 if n % 256 == 0 and mt * (n // 256) * 2 >= sms else 128
    tiles = mt * -(-n // bn)
    if splits is None:
        splits = 1 if tiles * 2 >= sms else \
            max(1, min(sms // tiles, nk // _split_steps(bm)))
    return dict(regime="prefill", blocks=min(tiles * splits, sms), bn=bn,
                splits=splits, pieces=1,
                work_ints=tiles * splits * bm * bn if splits > 1 else 0,
                counters=tiles if splits > 1 else 0)


_SMS: dict = {}
_COUNTERS: dict = {}
# guards insertions into _SMS and _COUNTERS (engine replicas launch from
# threads of their own)
_STATE_LOCK = threading.Lock()


def _sm_count(device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        with _STATE_LOCK:
            _SMS[idx] = torch.cuda.get_device_properties(
                idx).multi_processor_count
    return _SMS[idx]


def _counters(device, n: int) -> torch.Tensor:
    """Zeroed int32 arrival counters for a launch on the current stream:
    one buffer per (device, stream), which every launch leaves zeroed (see
    the kernel's source note).  Under CUDA-graph capture on a stream that
    has none yet, a buffer zeroed inside the graph (a memset node, in the
    graph's own memory) and not kept."""
    stream = torch.cuda.current_stream(device)
    key = (stream.device_index, stream.cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is not None and buf.numel() >= n:
        return buf
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(n, dtype=torch.int32, device=device)
    with _STATE_LOCK:
        buf = _COUNTERS.get(key)
        if buf is None or buf.numel() < n:
            _COUNTERS[key] = buf = torch.zeros(max(n, 1024),
                                               dtype=torch.int32,
                                               device=device)
    return buf


def _m_bucket(m: int) -> int:
    b = 1
    while b * 2 <= m:
        b *= 2
    return b


def _valid_tiles(tiles, n: int, k: int) -> Optional[dict]:
    """A table value as plan overrides the built kernel takes, or None:
    ``bn`` 128, or 256 where it divides N; ``splits`` clamped to
    1 .. K / 128."""
    if not isinstance(tiles, dict):
        return None
    try:
        bn, splits = int(tiles["bn"]), int(tiles["splits"])
    except (KeyError, TypeError, ValueError):
        return None
    if bn not in (128, 256) or (bn == 256 and n % 256):
        return None
    return {"bn": bn, "splits": max(1, min(splits, k // _BK))}


def get_qmm_tiles(m: int, n: int, k: int, dtype: str = "int8"
                  ) -> Optional[dict]:
    """The tuned plan overrides ``{"bn", "splits"}`` of an ``m x k @ k x
    n`` product above M = 16, or None (the default plan).  The tuning
    table first (op ``qmm_tiles``, M bucketed to its power of two); with
    ``PADDLE_TPU_TUNING=sweep`` and an untabled int8 shape on the card,
    a sweep of this shape recorded back into it; then the nearest tabled
    shape of the same device and dtype."""
    if m <= _DECODE_M:
        return None
    from ..utils import tuning as _tuning
    key = (_tuning.device_kind(), _m_bucket(m), n, k, dtype)
    tuned = _tuning.lookup("qmm_tiles", key)
    if tuned is None and dtype == "int8" and _tuning.sweep_enabled() \
            and torch.cuda.is_available():
        tuned = autotune_qmm_sweep(_m_bucket(m), n, k)
    if tuned is None:
        tuned = _tuning.lookup_nearest("qmm_tiles", key,
                                       match_idx=(0, 4), near_idx=(1, 2, 3))
    return _valid_tiles(tuned, n, k)


# one record per sweep: the shape, every candidate's ms and the winner
SWEEP_LOG: list = []
# calls of a plan in the CUDA graph whose replay the sweep times
_SWEEP_GRAPH_CALLS = 8


def autotune_qmm_sweep(m: int, n: int, k: int, iters: int = 20,
                       seed: int = 0) -> dict:
    """Time every plan of the built int8 kernel for an ``m x k @ k x n``
    product (M > 16) on the card: a CUDA graph of a few calls a plan,
    its replays timed with CUDA events in turns (``iters`` rounds, each
    plan once a round; the median per call), on random operands from
    ``seed``; check each output bitwise equal to the default plan's;
    record the fastest in the tuning table (op ``qmm_tiles``, source
    'sweep', its improvement over the default plan) and return it.
    Candidates are the plans the built kernel takes at run time: tile
    width 128 or 256 (where it divides N), times 1, 2, 4, ... k splits up
    to K / 128.  Raises on a failed launch or an output that differs."""
    from ..utils import tuning as _tuning
    if m <= _DECODE_M:
        raise ValueError(f"autotune_qmm_sweep: M={m} is in the decode "
                         f"regime (M <= {_DECODE_M}), which has no plan "
                         f"to choose")
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn(m, k, device=dev, generator=gen) * 0.1
    w = torch.randn(n, k, device=dev, generator=gen) * 0.1
    qx, sx = quantize_channel(x, axis=1, dtype="int8")
    qw_t, sw_t = quantize_channel(w, axis=1, dtype="int8")
    qx, qw_t, sw = qx.contiguous(), qw_t.contiguous(), sw_t.reshape(1, n)
    sms = _sm_count(dev)
    default = _qmm_plan(m, n, k, sms)
    cands = []
    for bn in (128, 256):
        if bn == 256 and n % 256:
            continue
        splits = 1
        while splits <= k // _BK:
            cands.append({"bn": bn, "splits": splits})
            splits *= 2
    base = {"bn": default["bn"], "splits": default["splits"]}
    if base not in cands:
        cands.insert(0, base)
    ref = _qmm_cuda(qx, qw_t, sx, sw, torch.float32, tiles=base)
    for c in cands:
        out = _qmm_cuda(qx, qw_t, sx, sw, torch.float32, tiles=c)
        if not torch.equal(out, ref):
            raise RuntimeError(f"autotune_qmm_sweep: plan {c} at "
                               f"({m}, {n}, {k}) differs from the default "
                               f"plan {base}")
    # one CUDA graph of _SWEEP_GRAPH_CALLS calls a plan, its replay timed:
    # the host's gap between two launches outlasts these kernels, so
    # launches from the host would time the host
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graphs = []
    with torch.cuda.stream(side):
        for c in cands:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=side):
                for _ in range(_SWEEP_GRAPH_CALLS):
                    _qmm_cuda(qx, qw_t, sx, sw, torch.float32, tiles=c)
            graphs.append(g)
    torch.cuda.current_stream(dev).wait_stream(side)
    times = {i: [] for i in range(len(cands))}
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    for _ in range(iters):
        for i, g in enumerate(graphs):
            t0.record()
            g.replay()
            t1.record()
            t1.synchronize()
            times[i].append(t0.elapsed_time(t1) / _SWEEP_GRAPH_CALLS)
    del graphs
    med = [sorted(t)[len(t) // 2] for t in times.values()]
    best = min(range(len(cands)), key=lambda i: med[i])
    base_ms = med[cands.index(base)]
    winner = dict(cands[best])
    improvement = (base_ms - med[best]) / base_ms if base_ms > 0 else 0.0
    _tuning.record("qmm_tiles", (_tuning.device_kind(), _m_bucket(m), n, k,
                                 "int8"), winner, source="sweep",
                   run=f"qmm-sweep-{m}x{n}x{k}", improvement=improvement)
    SWEEP_LOG.append({"m": m, "n": n, "k": k, "default": base,
                      "winner": winner, "improvement": improvement,
                      "ms": [(c["bn"], c["splits"], med[i])
                             for i, c in enumerate(cands)]})
    return winner


def _qmm_cuda(qx, qw_t, sx, sw, out_dtype, tiles=None):
    """The kernel on int8 or e4m3 ``qx [M, K]`` and transposed weight
    codes ``qw_t [N, K]`` of the same dtype, f32 ``sx [M, 1]`` and ``sw
    [1, N]``; raises on what it does not take: N and K multiples of 128,
    out dtype bf16/fp16/f32, contiguous 16-byte aligned tensors on one
    device.  e4m3 tiles above M = 16 are 128 columns wide: the f32 sum
    the kernel keeps beside the tensor cores' takes the registers a
    256-wide tile would need."""
    m, k = qx.shape
    n = qw_t.shape[0]
    if qw_t.shape[1] != k or tuple(sx.shape) != (m, 1) \
            or tuple(sw.shape) != (1, n):
        raise ValueError(f"quantized_matmul: shapes qx {tuple(qx.shape)}, "
                         f"qw_t {tuple(qw_t.shape)}, sx {tuple(sx.shape)}, "
                         f"sw {tuple(sw.shape)} do not agree")
    if n % 128 or k % 128:
        raise ValueError(f"quantized_matmul kernel needs N and K multiples "
                         f"of 128, got N={n}, K={k}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"quantized_matmul kernel writes bf16/fp16/f32, not "
                        f"{out_dtype}")
    if qx.dtype not in CODE_DTYPES:
        raise TypeError(f"quantized_matmul kernel needs int8 or e4m3 qx, got "
                        f"{qx.dtype}")
    codes = qx.dtype
    for name, t, dt in (("qx", qx, codes), ("qw_t", qw_t, codes),
                        ("sx", sx, torch.float32), ("sw", sw, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"quantized_matmul kernel needs {dt} {name}, got "
                            f"{t.dtype}")
        if t.device != qx.device:
            raise ValueError(f"quantized_matmul: {name} on {t.device}, qx on "
                             f"{qx.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"quantized_matmul kernel needs contiguous, "
                             f"16-byte aligned {name}")
    sms = _sm_count(qx.device)
    f8 = codes == torch.float8_e4m3fn
    if f8 and m > _DECODE_M:
        plan = _qmm_plan(m, n, k, sms, 128)
    else:
        # int8 above M = 16: the given overrides ({} the default plan),
        # else the tuning table's
        if tiles is None and not f8:
            tiles = get_qmm_tiles(m, n, k, "int8")
        plan = _qmm_plan(m, n, k, sms, (tiles or {}).get("bn"),
                         (tiles or {}).get("splits")) \
            if m > _DECODE_M else _qmm_plan(m, n, k, sms)
    y = torch.empty((m, n), dtype=out_dtype, device=qx.device)
    work = torch.empty(plan["work_ints"], dtype=torch.int32,
                       device=qx.device) if plan["work_ints"] else None
    counters = _counters(qx.device, plan["counters"]) \
        if plan["counters"] else None
    kernel = QUANTIZED_MATMUL_F8 if f8 else QUANTIZED_MATMUL
    kernel(_build.ptr(qx), _build.ptr(qw_t), _build.ptr(sx),
                     _build.ptr(sw), _build.ptr(y), _build.ptr(work),
                     _build.ptr(counters), m, n, k, _OUT_CODES[out_dtype],
                     plan["blocks"], plan["bn"], plan["splits"],
                     plan["work_ints"],
                     0 if counters is None else counters.numel(),
                     _build.stream_ptr(qx))
    return y


def _qmm_forward(x, w, dtype, out_dtype):
    """Quantize and dispatch, shared by :func:`quantized_matmul` and the
    fake-quant forward: returns ``(y [..., N], qx, sx, qw, sw)`` with
    ``qx``/``sx`` over the flattened ``[M, K]`` activations and ``qw``
    ``[K, N]``.  On the card the weight codes are made transposed
    (``quantize_channel`` of ``w.t()`` over its rows: the same codes and
    scales) and ``qw`` is their ``[K, N]`` view; any M goes to the kernel,
    where the JAX package sends ``M % 32 != 0`` to its composite."""
    _check_mode(dtype)
    lead, k, n = x.shape[:-1], x.shape[-1], w.shape[-1]
    qx, sx = quantize_channel(x.reshape(-1, k), axis=1, dtype=dtype)
    if x.device.type == "cpu":
        qw, sw = quantize_channel(w, axis=0, dtype=dtype)
        y = _qmm_plain(qx, qw, sx, sw, out_dtype)
    elif x.device.type == "cuda":
        qw_t, sw_t = quantize_channel(w.t(), axis=1, dtype=dtype)
        qw_t = qw_t.contiguous()
        sw = sw_t.reshape(1, n)
        y = _qmm_cuda(qx.contiguous(), qw_t, sx, sw, out_dtype)
        qw = qw_t.t()
    else:
        raise ValueError(f"quantized_matmul: unsupported device {x.device}")
    return y.reshape(*lead, n), qx, sx, qw, sw


def quantized_matmul(x, w, dtype: str = "int8", out_dtype=None):
    """``x [..., K] @ w [K, N]`` through ``dtype`` quantization
    (``'int8'`` or ``'fp8'``): activations amax-scaled per row, weights
    per output column, the 8-bit product's sums (exact int32, or f32)
    rescaled to ``out_dtype`` (default ``x.dtype``).
    CPU tensors run the plain version; CUDA tensors run the kernel or
    raise."""
    y, *_ = _qmm_forward(x, w, dtype, out_dtype or x.dtype)
    return y


class _FakeQuantMatmul(torch.autograd.Function):
    """Quantized forward; straight-through backward: the two plain
    products of the JAX ``_fake_quant_bwd`` over the dequantized operands
    in f32, as if quantization were the identity."""

    @staticmethod
    def forward(ctx, x, w, dtype):
        y, qx, sx, qw, sw = _qmm_forward(x, w, dtype, x.dtype)
        xdq = (qx.float() * sx).reshape(x.shape).to(x.dtype)
        wdq = (qw.float() * sw).to(w.dtype)
        ctx.save_for_backward(xdq, wdq)
        return y

    @staticmethod
    def backward(ctx, g):
        xdq, wdq = ctx.saved_tensors
        k, n = xdq.shape[-1], g.shape[-1]
        g2 = g.reshape(-1, n).float()
        dx = torch.matmul(g2, wdq.float().t())
        dw = torch.matmul(xdq.reshape(-1, k).float().t(), g2)
        return dx.reshape(xdq.shape).to(xdq.dtype), dw.to(wdq.dtype), None


def fake_quant_matmul(x, w, dtype: str = "int8"):
    """Quantized forward, straight-through backward: numerically
    ``fq(x) @ fq(w)`` with ``fq(t) = t + (qdq(t) - t).detach()``.  The
    parameters keep their dtype, so optimizers are untouched."""
    _check_mode(dtype)
    if not torch.is_grad_enabled() or not (x.requires_grad
                                           or w.requires_grad):
        # no backward to come: the forward alone, without the dequantized
        # copies the backward would keep
        return quantized_matmul(x, w, dtype)
    return _FakeQuantMatmul.apply(x, w, dtype)
