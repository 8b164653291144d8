"""The observatory report, offline (counterpart of
``paddle_tpu/observability/report.py``).

``python -m paddle_tpu_torch.observability.report`` renders the step-kind
registry, the HBM ledger, the doctor's verdicts and the tuning table as
text tables from files, not from a live process: a snapshot JSONL file
(``observability.write_snapshot``), a flight-recorder bundle directory,
a rows file whose lines carry ``doctor`` verdicts, and the tuning table
(``--tuning``, the file ``PADDLE_TPU_TUNING_CACHE`` names).  With no
arguments it tries the ``PADDLE_TPU_METRICS`` path, then the newest
bundle.  No card is needed.  The tables are the JAX package's, text for
text, for the same JSON.

    python -m paddle_tpu_torch.observability.report --snapshot m.jsonl
    python -m paddle_tpu_torch.observability.report --bundle DIR
    python -m paddle_tpu_torch.observability.report --tuning

Exit codes: 0 rendered something, 2 nothing to render.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

__all__ = ["render_executables", "render_hbm", "render_doctor",
           "render_tuning", "render_snapshot", "load_snapshot_file",
           "main"]


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024 or unit == "TB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return "-"


def _fmt(v, nd=2) -> str:
    if v is None:
        return "-"
    if isinstance(v, bool):
        return "y" if v else "n"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def _table(headers: List[str], rows: List[List[str]]) -> str:
    widths = [len(h) for h in headers]
    for r in rows:
        for i, c in enumerate(r):
            widths[i] = max(widths[i], len(c))
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    lines = [fmt.format(*headers), fmt.format(*["-" * w for w in widths])]
    lines += [fmt.format(*r) for r in rows]
    return "\n".join(lines)


def render_executables(execsnap: Optional[dict]) -> str:
    """The registry table: one row per step kind with its timings,
    cost and memory figures and roofline position."""
    if not execsnap or not execsnap.get("executables"):
        return "executables: none registered"
    head = (f"executables on {execsnap.get('device_kind', '?')} "
            f"(peak {execsnap.get('peak_flops', 0) / 1e12:.1f} TFLOP/s, "
            f"{execsnap.get('peak_hbm_gbps', 0):.0f} GB/s HBM"
            + (", NOMINAL host peaks" if execsnap.get("peaks_nominal")
               else "") + ")")
    rows = []
    for r in execsnap["executables"]:
        flops = r.get("flops")
        rows.append([
            r.get("component", "?"), r.get("name", "?"),
            r.get("kind", "?"), str(r.get("calls", 0)),
            _fmt(r.get("mean_ms"), 3),
            f"{flops / 1e9:.2f}" if flops else "-",
            _fmt_bytes(r.get("bytes_accessed")),
            _fmt_bytes(r.get("peak_bytes")),
            _fmt(r.get("arithmetic_intensity"), 1),
            r.get("bound", "-") or "-",
            f"{r['mfu'] * 100:.2f}%" if r.get("mfu") is not None else "-",
            f"{r['hbm_bw_frac'] * 100:.1f}%"
            if r.get("hbm_bw_frac") is not None else "-",
            f"{r['roof_frac'] * 100:.1f}%"
            if r.get("roof_frac") is not None else "-",
            _fmt(r.get("time_share")),
            _fmt(r.get("gap_share")),
            ("!" + r["analysis_error"][:40]) if r.get("analysis_error")
            else "",
        ])
    table = _table(
        ["component", "exec", "kind", "calls", "mean_ms", "GFLOP",
         "bytes", "peak_mem", "AI", "bound", "MFU", "BW%", "roof%",
         "t_share", "gap45%", "notes"], rows)
    overall = execsnap.get("overall") or {}
    tail = (f"analyzed {overall.get('analyzed', 0)}/"
            f"{overall.get('registered', 0)} executables, "
            f"{overall.get('runtime_ms', 0):.1f}ms steady-state wall")
    if overall.get("mfu") is not None:
        tail += (f", overall MFU {overall['mfu'] * 100:.2f}% "
                 f"(target {execsnap.get('mfu_target', 0.45) * 100:.0f}%)")
    return f"{head}\n{table}\n{tail}"


def render_hbm(h: Optional[dict]) -> str:
    if not h:
        return "hbm ledger: empty"
    rows = [[t.get("category", "?"), t.get("name", "?"),
             _fmt_bytes(t.get("bytes"))]
            for t in (h.get("tracked") or [])]
    table = _table(["category", "name", "bytes"], rows) if rows \
        else "(nothing tracked)"
    tail = (f"tracked {_fmt_bytes(h.get('tracked_bytes'))}, worst exec "
            f"temp {_fmt_bytes(h.get('exec_temp_bytes'))}"
            + (f" ({h['exec_temp_worst']})" if h.get("exec_temp_worst")
               else ""))
    cap = h.get("capacity_bytes")
    if cap:
        tail += (f", capacity {_fmt_bytes(cap)}, headroom "
                 f"{_fmt_bytes(h.get('headroom_bytes'))} "
                 f"({(h.get('headroom_frac') or 0) * 100:.1f}%)")
        if h.get("oom_risk"):
            tail += "  ** OOM RISK **"
    else:
        tail += ", capacity unknown (no device memory_stats; set " \
                "PADDLE_TPU_HBM_BYTES)"
    return f"hbm ledger\n{table}\n{tail}"


def _fmt_action(a) -> str:
    """Compact one-cell form of a verdict's structured action:
    ``param in [candidates]`` plus the table op / env when set; '-' for
    behavioral advice (no machine-turnable axis)."""
    if not isinstance(a, dict) or not a.get("param"):
        return "-"
    s = a["param"]
    cands = a.get("candidates")
    if cands:
        s += " in [" + ",".join(_fmt(c) for c in cands) + "]"
    if a.get("op"):
        s += f" ->{a['op']}"
    return s


def render_doctor(verdicts) -> str:
    if not verdicts:
        return "doctor: no bottleneck found"
    rows = []
    for v in verdicts:
        ev = v.get("evidence") or {}
        ev_s = ", ".join(f"{k}={ev[k]}" for k in list(ev)[:4])
        rows.append([v.get("bottleneck", "?"),
                     _fmt(v.get("score")), ev_s[:60],
                     (v.get("knob") or "")[:70],
                     _fmt_action(v.get("action"))[:46]])
    return "doctor verdicts\n" + _table(
        ["bottleneck", "score", "evidence", "knob", "action"], rows)


def render_tuning() -> str:
    """The tuning table with provenance: every op's entries and who
    committed each (source, run, measured improvement)."""
    from ..utils import tuning as _tuning
    ops = _tuning.all_entries()
    rows = []
    for op in sorted(ops):
        for key in sorted(ops[op]):
            meta = _tuning.provenance(op, key) or {}
            imp = meta.get("improvement")
            rows.append([
                op, "|".join(key), json.dumps(ops[op][key])[:40],
                meta.get("source", "-"), meta.get("run", "-"),
                f"+{imp * 100:.2f}%" if isinstance(imp, (int, float))
                else "-"])
    if not rows:
        return (f"tuning table: empty "
                f"({_tuning.tuning_path() or 'persistence off'})")
    return (f"tuning table ({_tuning.tuning_path() or 'in-process'})\n"
            + _table(["op", "key", "value", "source", "run",
                      "improvement"], rows))


def render_snapshot(rec: dict, doctor_rows: Optional[list] = None) -> str:
    """Render one snapshot record (``{'metrics', 'executables', 'hbm',
    ...}``): the registry, the ledger, and the doctor's verdicts on the
    digest built from them."""
    from . import doctor as _doctor
    from .exec_registry import profile_from_snapshot
    execsnap = rec.get("executables")
    h = rec.get("hbm")
    parts = [render_executables(execsnap), "", render_hbm(h)]
    # the doctor over the digest the live stats build, from the file
    stats = {"hbm": h}
    prof = profile_from_snapshot(execsnap or {})
    if prof:
        stats["exec_profile"] = prof
        stats["decode_steps"] = max(
            (r.get("calls", 0) for k, r in prof.items()
             if k in ("decode", "megakernel_decode", "spec_verify")),
            default=0)
    parts += ["", render_doctor(_doctor.diagnose(stats))]
    if doctor_rows:
        parts += ["", "latest bench-row doctor:",
                  render_doctor(doctor_rows)]
    ts = rec.get("ts")
    if ts:
        parts.insert(0, f"snapshot ts={ts}")
    return "\n".join(parts)


def load_snapshot_file(path: str) -> Optional[dict]:
    """Last parseable line of a snapshot JSONL file."""
    rec = None
    try:
        with open(path, errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
    except OSError:
        return None
    return rec if isinstance(rec, dict) else None


def _load_bundle(path: str) -> Optional[dict]:
    try:
        with open(os.path.join(path, "bundle.json"),
                  errors="replace") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _latest_rows_doctor(path: str) -> Optional[list]:
    last = None
    try:
        with open(path, errors="replace") as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and isinstance(
                        rec.get("doctor"), list):
                    last = rec["doctor"]
    except OSError:
        return None
    return last


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.observability.report",
        description="Render the observatory (registry, HBM ledger, "
                    "doctor, tuning table) from a snapshot file, a "
                    "flight-recorder bundle or a rows file, offline.")
    ap.add_argument("--snapshot", help="snapshot JSONL "
                    "(observability.write_snapshot output)")
    ap.add_argument("--bundle", help="flight-recorder bundle directory")
    ap.add_argument("--rows", help="a JSONL rows file (renders the "
                    "latest row's doctor verdicts alongside)")
    ap.add_argument("--tuning", action="store_true",
                    help="print the unified tuning table with "
                         "provenance (source/run/improvement)")
    args = ap.parse_args(argv)

    if args.tuning:
        print("== paddle_tpu_torch tuning table ==")
        print(render_tuning())
        if not (args.snapshot or args.bundle or args.rows):
            return 0

    rec = None
    source = None
    if args.snapshot:
        rec = load_snapshot_file(args.snapshot)
        source = args.snapshot
        if rec is None:
            print(f"report: no parseable snapshot line in "
                  f"{args.snapshot}", file=sys.stderr)
            return 2
    elif args.bundle:
        rec = _load_bundle(args.bundle)
        source = args.bundle
        if rec is None:
            print(f"report: {args.bundle} is not a readable bundle",
                  file=sys.stderr)
            return 2
    else:
        env = os.environ.get("PADDLE_TPU_METRICS", "")
        if env not in ("", "0", "1") and os.path.exists(env):
            rec = load_snapshot_file(env)
            source = env
        if rec is None:
            from . import flightrec as _fr
            bundles = _fr.find_bundles()
            if bundles:
                rec = _load_bundle(bundles[-1])
                source = bundles[-1]
    doctor_rows = _latest_rows_doctor(args.rows) if args.rows else None
    if rec is None and doctor_rows is not None:
        # --rows alone: the latest row's verdicts are the whole report
        print(f"== paddle_tpu_torch observatory report ({args.rows}) ==")
        print("latest bench-row doctor:")
        print(render_doctor(doctor_rows))
        return 0
    if rec is None:
        print("report: nothing to render — pass --snapshot/--bundle/"
              "--rows (see --help)", file=sys.stderr)
        return 2

    print(f"== paddle_tpu_torch observatory report ({source}) ==")
    if rec.get("reason"):
        print(f"flightrec reason: {rec['reason']}")
    print(render_snapshot(rec, doctor_rows=doctor_rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
