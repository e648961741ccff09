"""Radix prefix cache: content-addressed KV block reuse with COW forking
(the port's own copy of ``deepspeed_tpu/inference/v2/ragged/
prefix_cache.py``, the same pure Python: the same keys, refcounts,
eviction order and statistics).

Beyond the reference's FastGen (vLLM/SGLang-class feature): prompt blocks are
keyed by the exact chain of their token contents, forming a radix tree whose
edges are token RUNS, not just whole-block hashes. A later prompt sharing a
block-aligned prefix ADOPTS the cached blocks read-only — prefill compute and
KV writes are skipped for the matched region. A prompt that diverges
MID-block no longer loses the partial match: ``match_fork`` returns the
child entry sharing the longest token-run prefix so the engine can
copy-on-write its block (one whole-block copy inside the paged pool,
``model.cow_copy_block``) and keep only
the diverging tail to prefill.

Entry kinds:

* FULL entries (``len(tokens) == block_size``) — the classic chain nodes;
  they are what ``match``/``match_with_key`` walk and what ``len()`` counts.
* PARTIAL entries (``0 < len(tokens) < block_size``, via ``register_tail``) —
  leaf-only fork sources capturing a flushed sequence's sub-block tail (the
  common "system prompt shorter than a block boundary" case). They never
  gain children and are never adopted whole; they exist to be forked.

Ownership model (host-side, no device traffic — block ids only):

* while the sequence that computed a block is alive, the block belongs to
  that sequence; the cache entry just points at it.
* at sequence flush, ownership of registered blocks transfers to the cache
  (they are NOT returned to the allocator); unregistered blocks free
  normally.
* adopters take a reference (``refs``); flushing an adopter drops it.
  ``match_fork`` also takes a TRANSIENT reference on the fork-source entry
  so eviction cannot free it between the match and the device copy; the
  engine drops it via ``release([src_block])`` once the copy is dispatched.
* under allocator pressure the state manager evicts LRU leaf entries
  (``refs == 0`` and no cached children) back to the allocator — a parent
  is never evicted before its children, so every cached chain stays
  matchable root-first.

Safety: adopted blocks are never written (new tokens start at the
``seen_tokens`` boundary inside a PRIVATE block — after a fork that block is
the COW copy, never the shared source), and prefix caching is disabled for
sliding-window models whose mid-sequence trailing-window release would free
shared blocks. COW whole-block copies are safe because attention is causal:
the first ``p`` slots of the source block are bit-identical to what the
forking sequence would have computed, and slots past ``p`` are overwritten
by the fork's own prefill before any read can see them.
"""

from collections import deque
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np


class _Entry:
    __slots__ = ("block", "refs", "children", "last_use", "parent", "owned",
                 "tokens")

    def __init__(self, block: int, parent, tokens: np.ndarray):
        self.block = int(block)
        self.refs = 0          # live sequences currently adopting this block
        self.children = 0      # cached entries chained after this one
        self.last_use = 0
        self.parent = parent   # parent key or None
        self.owned = False     # True once the computing sequence flushed
        self.tokens = tokens   # this block's token run (len <= block_size)


class PrefixKVCache:

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self._entries: Dict[tuple, _Entry] = {}
        self._by_block: Dict[int, tuple] = {}
        # radix child index: parent key (None = root) -> child keys; lets
        # match_fork scan divergence candidates without hashing every entry
        self._kids: Dict[Optional[tuple], Set[tuple]] = {}
        self._clock = 0
        # single source of truth for the saved-prefill accounting: the
        # serving layer mirrors these into Prometheus counters, and the
        # bench cross-checks that mirror against this dict exactly
        self.stats = {"hits": 0, "misses": 0, "saved_tokens": 0,
                      "cow_forks": 0}
        self._depth_samples: deque = deque(maxlen=512)

    # ---- keys ----

    def _keys_for(self, tokens: np.ndarray) -> List[tuple]:
        bs = self.block_size
        keys, parent = [], None
        for i in range(len(tokens) // bs):
            parent = (parent, tokens[i * bs:(i + 1) * bs].tobytes())
            keys.append(parent)
        return keys

    # ---- lookup / adoption ----

    def match(self, tokens: np.ndarray) -> List[int]:
        """Block ids of the longest cached full-block prefix of ``tokens``
        (all matched entries' refcounts are incremented — the caller's
        sequence adopts them)."""
        ids, _ = self.match_with_key(tokens)
        return ids

    def match_with_key(self, tokens: np.ndarray) -> Tuple[List[int], Optional[tuple]]:
        """Like match(), also returning the LAST matched chain key so the
        caller can continue registering the chain without re-hashing the
        matched region."""
        self._clock += 1
        matched: List[_Entry] = []
        last_key = None
        for key in self._keys_for(np.asarray(tokens, np.int32)):
            e = self._entries.get(key)
            if e is None:
                break
            matched.append(e)
            last_key = key
        for e in matched:
            e.refs += 1
            e.last_use = self._clock
        return [e.block for e in matched], last_key

    def match_fork(self, tokens: np.ndarray
                   ) -> Tuple[List[int], Optional[tuple],
                              Optional[Tuple[tuple, int, int]]]:
        """Radix lookup: the full-block walk of ``match_with_key`` PLUS a
        fork candidate at the divergence point.

        Returns ``(full_block_ids, last_key, fork)`` where ``fork`` is
        ``None`` or ``(child_key, block_id, p)``: a child of ``last_key``
        whose token run shares ``p >= 1`` leading tokens with the remainder
        of ``tokens``. Matched full entries are adopted (refs bumped) as in
        ``match``; the fork source additionally takes one TRANSIENT ref the
        caller must drop with ``release([block_id])`` after the COW copy —
        that pin is what keeps the source alive while it is simultaneously
        an eviction candidate.

        Stats (hits/misses/saved_tokens/depth) are counted HERE and only
        here: this is the engine's adoption entry point, so direct test
        calls to ``match``/``match_with_key`` don't pollute the counters.
        """
        tokens = np.asarray(tokens, np.int32)
        matched, last_key = self.match_with_key(tokens)
        remaining = tokens[len(matched) * self.block_size:]
        fork = None
        if len(remaining) > 0:
            best = None  # (p, child_key, entry)
            for ck in self._kids.get(last_key, ()):
                e = self._entries.get(ck)
                if e is None or e.tokens is None:
                    continue
                m = min(len(e.tokens), len(remaining))
                if m == 0:
                    continue
                eq = e.tokens[:m] == remaining[:m]
                p = m if eq.all() else int(np.argmin(eq))
                if p >= 1 and (best is None or p > best[0]):
                    best = (p, ck, e)
            if best is not None:
                p, ck, e = best
                e.refs += 1                     # transient fork pin
                e.last_use = self._clock
                fork = (ck, e.block, p)
        saved = len(matched) * self.block_size
        if matched or fork is not None:
            self.stats["hits"] += 1
            self.stats["saved_tokens"] += saved
            self._depth_samples.append(saved + (fork[2] if fork else 0))
        else:
            self.stats["misses"] += 1
        return matched, last_key, fork

    def commit_fork(self, p: int) -> None:
        """The engine landed a COW copy covering ``p`` forked tokens: fold
        them into the saved-prefill accounting (kept out of ``match_fork``
        so an aborted fork — allocator full — never over-counts)."""
        self.stats["cow_forks"] += 1
        self.stats["saved_tokens"] += int(p)

    def release(self, block_ids: Sequence[int]) -> None:
        """An adopter flushed (or a fork pin is dropped): drop references."""
        for b in block_ids:
            key = self._by_block.get(int(b))
            if key is not None:
                self._entries[key].refs -= 1

    # ---- registration / ownership ----

    def register(self, tokens: np.ndarray, block_ids: Sequence[int]) -> List[int]:
        """Associate ``tokens``' full blocks with ``block_ids`` (the
        computing sequence's blocks, KV already written). Returns the ids
        actually registered; blocks whose chain is already cached are NOT
        re-registered (the duplicate computation keeps its own blocks,
        freed normally at flush)."""
        _, registered = self.register_from(None, tokens, block_ids)
        return registered

    def register_from(self, parent_key: Optional[tuple], tokens: np.ndarray,
                      block_ids: Sequence[int]) -> Tuple[Optional[tuple], List[int]]:
        """Chain-continuation registration: ``tokens`` (a multiple of
        block_size) continue the chain ending at ``parent_key`` (None =
        chain root). Lets a live sequence register each newly completed
        block in O(block) instead of re-hashing its whole history. Returns
        (new tail key, registered block ids)."""
        self._clock += 1
        registered = []
        bs = self.block_size
        tokens = np.asarray(tokens, np.int32)
        key = parent_key
        for i, b in zip(range(len(tokens) // bs), block_ids):
            parent = key
            run = tokens[i * bs:(i + 1) * bs]
            key = (parent, run.tobytes())
            b = int(b)
            e = self._entries.get(key)
            if e is not None:
                continue  # chain already cached by another sequence
            if b in self._by_block:
                continue  # block already backs another entry (shouldn't happen)
            e = _Entry(b, parent, run.copy())
            e.last_use = self._clock
            self._entries[key] = e
            self._by_block[b] = key
            self._kids.setdefault(parent, set()).add(key)
            if parent is not None and parent in self._entries:
                self._entries[parent].children += 1
            registered.append(b)
        return key, registered

    def register_tail(self, parent_key: Optional[tuple], tokens: np.ndarray,
                      block_id: int) -> bool:
        """Register a PARTIAL leaf entry: a flushed sequence's sub-block
        tail (``0 < len(tokens) < block_size`` tokens already written into
        ``block_id`` at slots ``[0, len)``). Partial entries never appear
        in the full-block walk and never gain children — they exist purely
        as fork sources for ``match_fork``. Returns True if inserted."""
        tokens = np.asarray(tokens, np.int32)
        if not 0 < len(tokens) < self.block_size:
            return False
        block_id = int(block_id)
        key = (parent_key, tokens.tobytes())
        if key in self._entries or block_id in self._by_block:
            return False
        self._clock += 1
        e = _Entry(block_id, parent_key, tokens.copy())
        e.last_use = self._clock
        self._entries[key] = e
        self._by_block[block_id] = key
        self._kids.setdefault(parent_key, set()).add(key)
        if parent_key is not None and parent_key in self._entries:
            self._entries[parent_key].children += 1
        return True

    def owns(self, block_id: int) -> bool:
        return int(block_id) in self._by_block

    def take_ownership(self, block_ids: Sequence[int]) -> List[int]:
        """The computing sequence flushed: registered blocks stay cached
        (returned list = blocks the CACHE now owns, i.e. must not be freed
        by the caller)."""
        kept = []
        for b in block_ids:
            key = self._by_block.get(int(b))
            if key is not None:
                self._entries[key].owned = True
                kept.append(int(b))
        return kept

    # ---- accounting / eviction ----

    @property
    def reclaimable_blocks(self) -> int:
        """Exactly what evict() could hand back right now: owned,
        unreferenced entries whose ENTIRE cached subtree is also owned and
        unreferenced (leaf-first eviction cannot pass a pinned or live
        child — counting those would let the scheduler admit work the
        allocator can never satisfy)."""
        memo: Dict[tuple, bool] = {}

        def evictable(key) -> bool:
            if key in memo:
                return memo[key]
            e = self._entries.get(key)
            ok = (e is not None and e.owned and e.refs <= 0
                  and all(evictable(k) for k in self._kids.get(key, ())))
            memo[key] = ok
            return ok

        return sum(1 for key in self._entries if evictable(key))

    def evict(self, n_blocks: int) -> List[int]:
        """Free up to ``n_blocks`` cache-owned LRU leaf blocks back to the
        caller (leaf-first keeps every remaining chain matchable)."""
        freed: List[int] = []
        while len(freed) < n_blocks:
            victims = [(e.last_use, key) for key, e in self._entries.items()
                       if e.owned and e.refs <= 0 and e.children == 0]
            if not victims:
                break
            victims.sort()
            for _, key in victims:
                if len(freed) >= n_blocks:
                    break
                e = self._entries.pop(key)
                self._by_block.pop(e.block, None)
                self._forget_kid(e.parent, key)
                if e.parent is not None and e.parent in self._entries:
                    self._entries[e.parent].children -= 1
                freed.append(e.block)
        return freed

    def _forget_kid(self, parent, key) -> None:
        kids = self._kids.get(parent)
        if kids is not None:
            kids.discard(key)
            if not kids:
                self._kids.pop(parent, None)

    def clear(self) -> List[int]:
        """Drop every entry (weights changed — cached KV content is stale).
        Returns the blocks the CACHE owned, for the caller to free; entries
        whose computing sequence is still live are forgotten without
        freeing (that sequence still owns its blocks)."""
        owned = [e.block for e in self._entries.values() if e.owned]
        self._entries.clear()
        self._by_block.clear()
        self._kids.clear()
        return owned

    # ---- reporting ----

    def report(self) -> Dict[str, object]:
        """Counters + structure snapshot for /health, env_report and the
        bench cross-check. ``saved_prefill_tokens`` is the exact number of
        prompt tokens adoption + COW forks kept out of prefill."""
        s = dict(self.stats)
        lookups = s["hits"] + s["misses"]
        samples = sorted(self._depth_samples)
        return {
            "hits": s["hits"],
            "misses": s["misses"],
            "hit_rate": (s["hits"] / lookups) if lookups else 0.0,
            "saved_prefill_tokens": s["saved_tokens"],
            "cow_forks": s["cow_forks"],
            "p50_match_depth": int(samples[len(samples) // 2]) if samples else 0,
            "entries": len(self._entries),
            "full_entries": len(self),
            "blocks": len(self._by_block),
        }

    def __len__(self):
        # full-block chain entries only: the unit every accounting contract
        # (and the engine's chain_blocks bookkeeping) is written in; partial
        # fork-source tails are auxiliary and counted via report()["entries"]
        bs = self.block_size
        return sum(1 for e in self._entries.values() if len(e.tokens) == bs)
