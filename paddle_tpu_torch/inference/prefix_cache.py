"""Radix prefix cache: shared prompt prefixes prefill once
(counterpart of ``paddle_tpu/inference/prefix_cache.py``, kept as the
port's own copy).

SGLang's observation (Zheng et al., *Efficiently Programming Large
Language Models using SGLang*): serving traffic is dominated by
requests sharing long prompt prefixes (system prompts, few-shot
preambles, chat history), so the KV cache of those prefixes should be
computed once and shared, which the paged layout makes cheap: sharing a
prefix is pointing two block tables at the same pool blocks and bumping
refcounts.

The tree is a radix tree over token sequences at BLOCK granularity:
each node owns exactly one pool block and is keyed by that block's
``block_size``-token chunk.  Matching a new prompt walks the tree chunk
by chunk; every matched node's block goes into the request's block
table and its refcount is bumped, so prefill runs only over the
divergent suffix.  Matching stops at the first non-equal chunk, so a
diverging request gets fresh blocks for its suffix: copy-on-write at
block granularity, because no writable reference to a shared block is
ever handed out.

Lifetime: the tree holds one allocator reference on every node's block,
independent of any slot.  When the pool runs dry the scheduler calls
:meth:`evict`, which walks leaves in LRU order and frees only blocks
nobody else references; blocks pinned by an active slot are skipped.
Host-side only: no tensors.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

__all__ = ["RadixPrefixCache", "fingerprint_chain", "path_fingerprint",
           "score_overlap"]


def fingerprint_chain(tokens, block_size: int):
    """The rolling path fingerprints of ``tokens``'s full-block prefix
    chunks (capped at len-1, mirroring ``match()`` — at least one token
    is always left to prefill).  Depends only on (tokens, block_size),
    so a router scoring N replicas computes it ONCE and intersects each
    replica's fingerprint set against it."""
    bs = int(block_size)
    toks = [int(t) for t in tokens]
    usable = (len(toks) - 1) // bs
    chain = []
    h = 0
    for i in range(usable):
        h = path_fingerprint(h, tuple(toks[i * bs:(i + 1) * bs]))
        chain.append(h)
    return chain


def score_overlap(tokens, summary: dict, chain=None) -> int:
    """Blocks of ``tokens``'s prefix present in a replica ``summary()``
    digest: consecutive fingerprint-chain matches from the root — the
    score equals the block count match() would return on that replica.
    ``chain`` short-circuits the rolling hash with a precomputed
    ``fingerprint_chain(tokens, summary['block_size'])`` (the router
    scores N replicas against one prompt)."""
    fps = summary["fingerprints"]
    if chain is None:
        chain = fingerprint_chain(tokens, summary["block_size"])
    score = 0
    for h in chain:
        if h not in fps:
            break
        score += 1
    return score


class _Node:
    __slots__ = ("key", "block", "children", "parent", "last_used",
                 "path_hash")

    def __init__(self, key: Optional[tuple], block: Optional[int],
                 parent: Optional["_Node"]):
        self.key = key            # block_size-token tuple (None at root)
        self.block = block        # pool block id (None at root)
        self.parent = parent
        self.children: Dict[tuple, "_Node"] = {}
        self.last_used = 0
        # rolling hash of the root->node chunk path (see path_fingerprint):
        # what the router matches against without ever seeing the tree
        self.path_hash = 0


def path_fingerprint(parent_hash: int, chunk: tuple) -> int:
    """Rolling fingerprint of a chunk path: hash of (parent fingerprint,
    chunk).  Stable within a process (tuple/int hashing), cheap to roll
    forward token-block by token-block — the router recomputes it over
    an incoming prompt and intersects with replica summaries, so two
    sides agree on 'same prefix' iff the chunk paths are equal."""
    return hash((parent_hash, chunk))


class RadixPrefixCache:
    """Block-granular radix tree over token prefixes.

    The cache owns one allocator reference per node; `match` hands the
    caller block ids to alias into a slot's table (the caller increfs
    them for the slot's own lifetime), `insert` adopts a freshly
    prefilled slot's blocks into the tree, `evict` trims LRU leaves
    whose blocks nobody else holds.
    """

    def __init__(self, allocator, block_size: int):
        self._alloc = allocator
        self.block_size = int(block_size)
        self._root = _Node(None, None, None)
        self._nodes = 0
        self._clock = itertools.count(1)
        # block-granular fingerprint index: the path hash of every live
        # node, maintained INCREMENTALLY on insert/evict so summary()
        # never walks the tree (it sits on the router's per-request
        # scoring path)
        self._fingerprints: set = set()
        # stats the engine/load harness report
        self.queries = 0
        self.hit_queries = 0
        self.hit_blocks = 0
        self.inserted_blocks = 0
        self.evicted_blocks = 0

    def __len__(self):
        return self._nodes

    @property
    def cached_blocks(self) -> int:
        return self._nodes

    # ---- lookup -------------------------------------------------------
    def _chunks(self, tokens) -> List[tuple]:
        bs = self.block_size
        toks = [int(t) for t in tokens]
        return [tuple(toks[i:i + bs])
                for i in range(0, len(toks) - bs + 1, bs)]

    def match(self, tokens) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens``: returns (blocks,
        matched_token_count).  Only FULL blocks match, and at least one
        token is always left for the caller to prefill (a prefill must
        see >= 1 real token to produce next-token logits), so the match
        is capped at ``len(tokens) - 1`` rounded down to a block
        boundary.  Touches the matched path's LRU clocks."""
        self.queries += 1
        usable = (len(tokens) - 1) // self.block_size
        blocks: List[int] = []
        node = self._root
        tick = next(self._clock)
        for chunk in self._chunks(tokens)[:usable]:
            child = node.children.get(chunk)
            if child is None:
                break
            child.last_used = tick
            blocks.append(child.block)
            node = child
        if blocks:
            self.hit_queries += 1
            self.hit_blocks += len(blocks)
        return blocks, len(blocks) * self.block_size

    # ---- insertion ----------------------------------------------------
    def insert(self, tokens, blocks: List[int]) -> int:
        """Register a prefilled prompt: ``blocks[i]`` holds tokens
        ``[i*bs, (i+1)*bs)``.  Existing nodes win (a concurrent
        identical prompt admitted cold keeps the FIRST copy; the
        duplicate blocks stay slot-owned and retire normally).  New
        nodes incref their block — the tree's own reference.  Returns
        the number of newly adopted blocks."""
        node = self._root
        adopted = 0
        tick = next(self._clock)
        for chunk, block in zip(self._chunks(tokens), blocks):
            child = node.children.get(chunk)
            if child is None:
                child = _Node(chunk, int(block), node)
                child.path_hash = path_fingerprint(node.path_hash, chunk)
                node.children[chunk] = child
                self._alloc.incref([int(block)])
                self._fingerprints.add(child.path_hash)
                self._nodes += 1
                adopted += 1
            child.last_used = tick
            node = child
        self.inserted_blocks += adopted
        return adopted

    # ---- eviction -----------------------------------------------------
    def _leaves(self) -> List[_Node]:
        out, stack = [], [self._root]
        while stack:
            n = stack.pop()
            if n is not self._root and not n.children:
                out.append(n)
            stack.extend(n.children.values())
        return out

    def _drop(self, node: _Node) -> None:
        node.parent.children.pop(node.key, None)
        self._alloc.decref([node.block])
        self._fingerprints.discard(node.path_hash)
        self._nodes -= 1
        self.evicted_blocks += 1

    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` pool blocks by dropping LRU leaves
        whose block only the tree references (refcount 1 — a block a
        live slot still uses is pinned).  Dropping a leaf may expose
        its parent as the next LRU leaf, so parents are PROMOTED into
        the candidate heap as their last child falls — one tree walk
        per call, not one per freed block (eviction sits on the
        admission hot path).  Returns blocks freed."""
        import heapq
        heap = [(lf.last_used, id(lf), lf) for lf in self._leaves()]
        heapq.heapify(heap)
        freed = 0
        while heap and freed < n_blocks:
            _, _, node = heapq.heappop(heap)
            # re-check at pop time: the node must still be an attached
            # leaf (heap entries can go stale as the tree mutates) and
            # unpinned (refcounts don't change within a call, so a
            # skipped pinned leaf stays out for good)
            if node.children or \
                    node.parent.children.get(node.key) is not node:
                continue
            if self._alloc.refcount(node.block) != 1:
                continue                       # pinned by a live slot
            parent = node.parent
            self._drop(node)
            freed += 1
            if parent is not self._root and not parent.children:
                heapq.heappush(heap,
                               (parent.last_used, id(parent), parent))
        return freed

    def flush(self) -> int:
        """Drop EVERY node, releasing the tree's references (blocks a
        slot still uses survive under the slot's own reference).  The
        drain/leak accounting path."""
        dropped = 0
        stack = list(self._root.children.values())
        order: List[_Node] = []
        while stack:
            n = stack.pop()
            order.append(n)
            stack.extend(n.children.values())
        for n in reversed(order):          # leaves before parents
            self._drop(n)
            dropped += 1
        return dropped

    # ---- router-facing summary ----------------------------------------
    def summary(self) -> dict:
        """Cheap per-replica digest for cache-aware routing: the
        block-granular fingerprint set (path hashes of every cached
        chunk path — maintained incrementally, O(1) to hand out) plus
        hit/evict counters.  A router scores an incoming prompt by
        rolling :func:`path_fingerprint` over its chunks and counting
        how many consecutive hashes live in ``fingerprints`` — prefix
        overlap without ever walking this replica's tree."""
        return {
            "block_size": self.block_size,
            "fingerprints": self._fingerprints,
            "cached_blocks": self._nodes,
            "hit_queries": self.hit_queries,
            "queries": self.queries,
            "evicted_blocks": self.evicted_blocks,
        }

    # ---- stats --------------------------------------------------------
    @property
    def stats(self) -> dict:
        return {
            "prefix_queries": self.queries,
            "prefix_hit_queries": self.hit_queries,
            "prefix_hit_rate": round(self.hit_queries / self.queries, 4)
            if self.queries else 0.0,
            "prefix_hit_blocks": self.hit_blocks,
            "prefix_cached_blocks": self._nodes,
            "prefix_evicted_blocks": self.evicted_blocks,
        }
