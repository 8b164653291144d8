"""Prefix-aware routing over engine replicas (counterpart of
``paddle_tpu/inference/router.py``).

N replicas behind round-robin are N independent caches: a tenant's
system prompt is prefilled on every replica and each copy is cold most
of the time.  The router sends a request to the replica that already
holds its prefix (SGLang's cache-aware routing): each replica's radix
cache keeps a block-granular fingerprint set (``prefix_summary()``,
rolling path hashes kept up to date on insert and evict), the router
rolls the same fingerprint over the prompt's chunks and scores each
replica by the consecutive blocks it could serve
(``prefix_cache.score_overlap``).  The highest score wins; a request
with no score, and a tie, goes to the least-loaded replica, so the
router falls back to load balancing exactly when cache affinity has
nothing to say.  ``max_load_gap`` bounds affinity by load.

The router is host-side scheduling over ordinary engines: it reads
prompts, summaries and queue depths, never device state.  Replicas are
``InferenceEngine`` or ``DisaggServingEngine`` objects in one process
(the load harness drives each from a thread of its own) or, through
``ReplicaRPCServer`` / ``RPCReplicaProxy``, engines behind a loopback
socket.  ``policy='round_robin'`` is the baseline.
"""
from __future__ import annotations

import itertools
import json
import socket
import struct
import threading
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..observability import metrics as _metrics
from .prefix_cache import fingerprint_chain, score_overlap

__all__ = ["Router", "ReplicaRPCServer", "RPCReplicaProxy"]

_POLICIES = ("prefix", "least_loaded", "round_robin")


class Router:
    """Request router over engine replicas.

    Usage::

        router = Router([eng_a, eng_b])          # policy='prefix'
        ridx, rid = router.add_request(prompt, max_new_tokens=64)
        outputs = router.run()                   # {(ridx, rid): tokens}
    """

    def __init__(self, replicas: Sequence, policy: str = "prefix",
                 max_load_gap: Optional[int] = None):
        if not replicas:
            raise ValueError("router needs at least one replica")
        if policy not in _POLICIES:
            raise ValueError(f"policy must be one of {_POLICIES}, "
                             f"got {policy!r}")
        self.replicas = list(replicas)
        self.policy = policy
        # following a prefix onto a replica already max_load_gap requests
        # deeper than the least-loaded one trades a re-prefill for a queue
        # wait; default: one full slot generation
        if max_load_gap is None:
            max_load_gap = max(getattr(r, "batch_slots", 1)
                               for r in self.replicas)
        self.max_load_gap = int(max_load_gap)
        self._rr = itertools.cycle(range(len(self.replicas)))
        self.routed = [0] * len(self.replicas)
        self.requests = 0
        self.prefix_routed = 0        # placed by a positive overlap
        self.prefix_blocks_routed = 0
        self._m_routed = _metrics.counter(
            "router_requests_total", "requests placed",
            labels=("policy",)).labels(policy=self.policy)
        self._m_prefix_routed = _metrics.counter(
            "router_prefix_routed_total",
            "requests placed by prefix affinity")
        self._aggregator = None

    # ---- scoring ------------------------------------------------------
    @staticmethod
    def _load(replica) -> int:
        """Every request the replica accepted and has not finished:
        queued, active and (disaggregated) parked handoffs."""
        return (len(replica._queue) + replica.num_active
                + len(getattr(replica, "_handoffs", ())))

    def route(self, prompt) -> int:
        """Pick the replica for ``prompt``; returns its index and counts
        the decision."""
        self.requests += 1
        if self.policy == "round_robin":
            idx = next(self._rr)
        elif self.policy == "least_loaded":
            idx = int(np.argmin([self._load(r) for r in self.replicas]))
        else:
            # the chain depends only on (prompt, block size): rolled once
            # per block size, then each replica costs set lookups
            chains: Dict[int, list] = {}
            scores = []
            for r in self.replicas:
                summ = r.prefix_summary() if hasattr(r, "prefix_summary") \
                    else None
                if not summ:
                    scores.append(0)
                    continue
                bs = int(summ["block_size"])
                if bs not in chains:
                    chains[bs] = fingerprint_chain(prompt, bs)
                scores.append(score_overlap(prompt, summ, chain=chains[bs]))
            best = max(scores)
            loads = [self._load(r) for r in self.replicas]
            if best > 0:
                tied = [i for i, s in enumerate(scores) if s == best]
                idx = min(tied, key=lambda i: loads[i])
                if loads[idx] - min(loads) > self.max_load_gap:
                    idx = int(np.argmin(loads))   # balance wins the tail
                else:
                    self.prefix_routed += 1
                    self.prefix_blocks_routed += best
                    self._m_prefix_routed.inc()
            else:
                idx = int(np.argmin(loads))
        self.routed[idx] += 1
        self._m_routed.inc()
        return idx

    # ---- request plumbing ---------------------------------------------
    def add_request(self, prompt, **kw) -> Tuple[int, int]:
        """Route and enqueue; returns ``(replica index, request id)``."""
        idx = self.route(prompt)
        return idx, self.replicas[idx].add_request(prompt, **kw)

    @property
    def has_work(self) -> bool:
        return any(r.has_work for r in self.replicas)

    def step(self) -> int:
        """One round: every replica with work advances one step.  Returns
        the tokens produced across the fleet."""
        produced = 0
        for r in self.replicas:
            if r.has_work:
                produced += r.step_or_raise()
        return produced

    def run(self) -> Dict[Tuple[int, int], np.ndarray]:
        while self.has_work:
            self.step()
        return self.results()

    def results(self) -> Dict[Tuple[int, int], np.ndarray]:
        """``{(replica index, request id): tokens}`` over every replica."""
        return {(i, rid): toks for i, r in enumerate(self.replicas)
                for rid, toks in r.results.items()}

    def drain(self, timeout_s: Optional[float] = None) -> List:
        """Drain every replica (each checks its pool leak-free); returns
        the still-queued requests, replica by replica."""
        leftover = []
        for r in self.replicas:
            leftover.extend(r.drain(timeout_s))
        return leftover

    # ---- telemetry ----------------------------------------------------
    def scrape_metrics(self, monitor=None) -> dict:
        """One ``FleetAggregator`` pass over the replicas: their new
        finished-request records into the fleet registry metrics, and
        optionally into an ``SLOMonitor``.  Host dict reads only."""
        if self._aggregator is None:
            from ..observability.slo import FleetAggregator
            self._aggregator = FleetAggregator(self.replicas,
                                               monitor=monitor)
        elif monitor is not None:
            self._aggregator.monitor = monitor
        return self._aggregator.scrape()

    def stats(self) -> dict:
        """Where requests went and why: the router hit rate (how often
        cache affinity, not load, made the call), requests and prefix
        blocks routed, each replica's load."""
        reqs = max(self.requests, 1)
        return {
            "policy": self.policy,
            "replicas": len(self.replicas),
            "requests_routed": self.requests,
            "routed_per_replica": list(self.routed),
            "router_hit_rate": round(self.prefix_routed / reqs, 4),
            "router_prefix_blocks": self.prefix_blocks_routed,
            "replica_loads": [self._load(r) for r in self.replicas],
        }


# ---------------------------------------------------------------------------
# Replica transport: length-prefixed JSON frames (a 4-byte big-endian length,
# then UTF-8 JSON) over one TCP connection per proxy, request and response in
# lockstep.  The server runs every engine call under one lock; the proxy
# duck-types the replica surface the Router, FleetAggregator and the fleet
# harness read (``_queue``, ``num_active``, ``blocks_in_use``, ``_timings``,
# ``request_stats``, ``results``) from snapshots refreshed by every step and
# scrape.
#
# Same host by design: radix fingerprints are Python ``hash()`` values, so
# summaries agree across PROCESSES only when every process pins the same
# PYTHONHASHSEED.
# ---------------------------------------------------------------------------

def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON-serializable: {type(o).__name__}")


def _send_frame(sock, obj) -> None:
    data = json.dumps(obj, default=_json_default).encode("utf-8")
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv_exact(sock, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _recv_frame(sock) -> Optional[dict]:
    hdr = _recv_exact(sock, 4)
    if hdr is None:
        return None
    (n,) = struct.unpack(">I", hdr)
    body = _recv_exact(sock, n)
    return None if body is None else json.loads(body.decode("utf-8"))


def _load_snapshot(r) -> dict:
    return {"queue_len": len(r._queue),
            "handoffs": len(getattr(r, "_handoffs", ())),
            "num_active": int(r.num_active),
            "blocks_in_use": r.blocks_in_use,
            "has_work": bool(r.has_work)}


class ReplicaRPCServer:
    """Serve one replica over the socket protocol.  ``port=0`` binds an
    ephemeral port; ``address`` is the ``(host, port)`` a proxy connects
    to.  Every engine call runs under ``lock`` (default: a private one),
    so concurrent connections are safe."""

    def __init__(self, replica, host: str = "127.0.0.1", port: int = 0,
                 lock: Optional[threading.Lock] = None):
        self.replica = replica
        self._lock = lock if lock is not None else threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(16)
        self.address = self._sock.getsockname()
        self._stop = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None

    def start(self) -> "ReplicaRPCServer":
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        """Stop accepting (open connections end when their proxy
        closes)."""
        self._stop.set()
        try:
            # wakes a blocked accept(); close alone does not on Linux
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        t = self._accept_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                break
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn) -> None:
        with conn:
            while not self._stop.is_set():
                try:
                    msg = _recv_frame(conn)
                except OSError:
                    break
                if msg is None:
                    break
                try:
                    resp = {"ok": True, "r": self._dispatch(msg)}
                except Exception as e:   # the caller gets the error
                    resp = {"ok": False, "e": f"{type(e).__name__}: {e}"}
                try:
                    _send_frame(conn, resp)
                except OSError:
                    break

    def _snapshot(self) -> dict:
        """The proxy-side replica surface as one JSON-safe dict.  The
        caller holds the lock."""
        r = self.replica
        return {
            "timings": dict(r._timings),
            "request_stats": {int(k): dict(v)
                              for k, v in r.request_stats.items()},
            "results": {int(k): np.asarray(v).tolist()
                        for k, v in r.results.items()},
            **_load_snapshot(r),
        }

    def _dispatch(self, msg: dict):
        m = msg.get("m")
        r = self.replica
        if m == "ping":
            return {"vocab_size": int(r.model.cfg.vocab_size),
                    "batch_slots": int(r.batch_slots),
                    "request_stats_cap": int(getattr(
                        r, "_request_stats_cap", 4096))}
        if m == "summary":
            with self._lock:
                summ = r.prefix_summary()
                if summ is None:
                    return None
                out = dict(summ)
                out["fingerprints"] = list(summ["fingerprints"])
            return out
        if m == "add_request":
            prompt = np.asarray(msg["prompt"], np.int32)
            with self._lock:
                return int(r.add_request(prompt, **msg.get("kw", {})))
        if m == "load":
            with self._lock:
                return _load_snapshot(r)
        if m == "step":
            with self._lock:
                produced = r.step_or_raise()
                return {"produced": int(produced), "snap": self._snapshot()}
        if m == "scrape":
            with self._lock:
                return self._snapshot()
        if m == "stop":
            self.stop()
            return True
        raise ValueError(f"unknown RPC method {m!r}")


class RPCReplicaProxy:
    """Client half: the replica surface from cached snapshots.
    ``prefix_summary()`` and ``add_request`` are live round trips (the
    Router's two calls); ``step_or_raise`` steps the remote engine and
    refreshes the snapshot in the same round trip; ``refresh_stats()``
    is the explicit pull a ``FleetAggregator`` makes."""

    def __init__(self, address, connect_timeout: float = 5.0):
        self.address = tuple(address)
        self._sock = socket.create_connection(self.address,
                                              timeout=connect_timeout)
        # a step may wait behind a cold kernel build: no read deadline
        self._sock.settimeout(None)
        self._lock = threading.Lock()
        self._prefix = None               # the radix cache lives remotely
        self._timings: dict = {}
        self.request_stats: Dict[int, dict] = {}
        self.results: Dict[int, np.ndarray] = {}
        self._queue: tuple = ()
        self._handoffs: tuple = ()
        self.num_active = 0
        self.blocks_in_use = None
        self._has_work = False
        info = self._call("ping")
        self.batch_slots = int(info["batch_slots"])
        self._request_stats_cap = int(info["request_stats_cap"])
        self.model = SimpleNamespace(cfg=SimpleNamespace(
            vocab_size=int(info["vocab_size"])))
        self.refresh_stats()

    def _call(self, method: str, **fields):
        msg = {"m": method}
        msg.update(fields)
        with self._lock:
            _send_frame(self._sock, msg)
            resp = _recv_frame(self._sock)
        if resp is None:
            raise ConnectionError("replica RPC connection closed")
        if not resp.get("ok"):
            raise RuntimeError(f"replica RPC failed: {resp.get('e')}")
        return resp.get("r")

    def _apply(self, snap: dict) -> None:
        self._timings = snap["timings"]
        self.request_stats.update(
            {int(k): v for k, v in snap["request_stats"].items()})
        self.results.update({int(k): np.asarray(v, np.int32)
                             for k, v in snap["results"].items()})
        self._apply_load(snap)

    def _apply_load(self, snap: dict) -> None:
        self._queue = (None,) * int(snap["queue_len"])
        self._handoffs = (None,) * int(snap["handoffs"])
        self.num_active = int(snap["num_active"])
        self.blocks_in_use = snap["blocks_in_use"]
        self._has_work = bool(snap["has_work"])

    def refresh_stats(self) -> None:
        self._apply(self._call("scrape"))

    def prefix_summary(self) -> Optional[dict]:
        summ = self._call("summary")
        if summ is None:
            return None
        summ["fingerprints"] = set(summ["fingerprints"])
        return summ

    def add_request(self, prompt, **kw) -> int:
        kw = {k: v for k, v in kw.items() if v is not None}
        return int(self._call("add_request",
                              prompt=np.asarray(prompt).tolist(), kw=kw))

    @property
    def has_work(self) -> bool:
        self._apply_load(self._call("load"))
        return self._has_work

    def step_or_raise(self) -> int:
        out = self._call("step")
        self._apply(out["snap"])
        return int(out["produced"])

    def step(self) -> int:
        return self.step_or_raise()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
