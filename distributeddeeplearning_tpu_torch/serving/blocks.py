"""Block-granular KV-cache accounting for the paged serving engine.

Copied from ``distributeddeeplearning_tpu/serving/blocks.py`` (pure
numpy, so the port shares the JAX package's allocation, refcount and
prefix-cache behaviour block for block), with the fleet-wide
``PrefixDirectory`` the router publishes to and adopts from.

vLLM's PagedAttention observation, TPU-adapted: a dense slot pool wastes
most of its HBM on long-tail traffic because every slot owns a full
``max_len`` row. Here the physical KV store is a fixed
``[num_blocks, block_size, heads, head_dim]`` tensor per layer and each
request maps *logical* blocks (position // block_size) to *physical*
blocks through a per-slot int32 table. This module is the host-side
brain of that mapping — pure Python/numpy, no jax:

* **allocation** — a free list of physical block ids; ``alloc`` raises
  :class:`BlockPoolExhausted` when the pool (free + evictable) cannot
  cover a request, which the scheduler turns into admission
  backpressure (queued requests wait; a full queue raises ``QueueFull``
  at ``submit``, same as slot exhaustion).
* **refcounting + prefix cache** — full prompt blocks are content-hashed
  (a position-dependent chain, so block k's hash commits to every token
  before it) and registered; a later request whose prompt starts with
  the same block-aligned prefix maps its leading table entries to the
  *same physical blocks* (refcount++) and prefills only its suffix.
  RadixAttention's reuse, restricted to block granularity.
* **LRU retention** — blocks whose refcount drops to zero but that are
  registered in the prefix cache stay resident (evictable, LRU) so a
  follow-up request can still hit them; ``alloc`` evicts from that LRU
  only when the free list is empty.
* **copy-on-write** — ``ensure_private`` hands a writer its own block.
  Because sharing is restricted to *full* prompt blocks and writes
  start at the block-aligned shared length, the serving engine never
  writes a shared block mid-content — so "copy" never needs a device
  copy: a shared block is swapped for a fresh one (the caller fully
  rewrites it), and a privately-held but registered block is simply
  unregistered.

Physical block **0 is the trash sink**: never allocated, every unused
table entry points at it, so a compiled program's padded-tail writes
land harmlessly in rows no request ever attends (position masks keep
them unread). The pool therefore serves ``num_blocks - 1`` real blocks.
"""

from __future__ import annotations

import collections
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

TRASH_BLOCK = 0


class BlockPoolExhausted(RuntimeError):
    """Not enough free (or evictable) physical blocks for a request."""


def hash_prefix_chain(tokens: np.ndarray, block_size: int) -> List[bytes]:
    """Position-dependent content hashes for every FULL block of
    ``tokens``: ``h_k = H(h_{k-1} || tokens[k*bs:(k+1)*bs])``. Chaining
    makes block k's hash commit to the whole prefix before it, so two
    prompts share block k only when they agree on every earlier token."""
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    out: List[bytes] = []
    prev = b""
    for k in range(len(toks) // block_size):
        h = hashlib.sha1(
            prev + toks[k * block_size:(k + 1) * block_size].tobytes()
        ).digest()
        out.append(h)
        prev = h
    return out


class BlockAllocator:
    """Host-side ledger of the physical block pool.

    Invariants (pinned by ``tests/test_serving_paged.py``):

    * block 0 (trash) is never handed out;
    * every id is in exactly one of {free list, LRU cache, referenced};
    * a registered hash always maps to a resident block (referenced or
      cached), and eviction removes the mapping with the block.
    """

    def __init__(self, num_blocks: int, block_size: int) -> None:
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the trash sink), "
                f"got {num_blocks}"
            )
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free: collections.deque = collections.deque(
            range(1, num_blocks)
        )
        self._ref: Dict[int, int] = {}
        self._hash_of: Dict[int, bytes] = {}
        self._by_hash: Dict[bytes, int] = {}
        # zero-ref blocks still registered in the prefix cache, oldest
        # first — the eviction order when the free list runs dry.
        self._lru: "collections.OrderedDict[int, None]" = (
            collections.OrderedDict()
        )
        # Blocks the fleet-wide prefix directory maps on this replica:
        # never evicted, never recycled to the free list while pinned
        # (docs/SERVING.md disaggregation section).
        self._pinned: set = set()
        self.stats = {
            "allocated": 0, "freed": 0, "evicted": 0, "cow": 0,
            "prefix_hit_blocks": 0, "prefix_hit_requests": 0,
            "registered": 0, "peak_live": 0,
        }

    # -- capacity ----------------------------------------------------------

    @property
    def capacity(self) -> int:
        """Allocatable blocks (the trash sink excluded)."""
        return self.num_blocks - 1

    @property
    def free_count(self) -> int:
        """Blocks an ``alloc`` could hand out right now (free +
        evictable cached; pinned cache entries are not evictable)."""
        pinned_cached = sum(1 for b in self._lru if b in self._pinned)
        return len(self._free) + len(self._lru) - pinned_cached

    @property
    def live_count(self) -> int:
        """Blocks currently referenced by at least one request."""
        return len(self._ref)

    def blocks_for_tokens(self, n_tokens: int) -> int:
        """Physical blocks needed to hold ``n_tokens`` written positions."""
        if n_tokens <= 0:
            return 0
        return -(-int(n_tokens) // self.block_size)

    # -- alloc / free ------------------------------------------------------

    def _evict_one(self) -> int:
        bid = next(
            (b for b in self._lru if b not in self._pinned), None
        )
        if bid is None:  # alloc's free_count guard makes this unreachable
            raise BlockPoolExhausted("every cached block is pinned")
        del self._lru[bid]
        h = self._hash_of.pop(bid, None)
        if h is not None:
            self._by_hash.pop(h, None)
        self.stats["evicted"] += 1
        return bid

    def alloc(self, n: int) -> List[int]:
        """``n`` fresh private blocks (refcount 1 each), evicting
        zero-ref cached blocks LRU-first when the free list is empty.
        All-or-nothing: raises :class:`BlockPoolExhausted` without
        side effects when the pool cannot cover the request."""
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        if n > self.free_count:
            raise BlockPoolExhausted(
                f"need {n} blocks, {self.free_count} available "
                f"({len(self._free)} free, {len(self._lru)} evictable) "
                f"of {self.capacity}"
            )
        out: List[int] = []
        for _ in range(n):
            bid = self._free.popleft() if self._free else self._evict_one()
            self._ref[bid] = 1
            out.append(bid)
        self.stats["allocated"] += n
        self.stats["peak_live"] = max(self.stats["peak_live"], len(self._ref))
        return out

    def incref(self, bid: int) -> None:
        self._ref[bid] += 1

    def decref(self, bid: int) -> None:
        """Drop one reference. At zero the block either stays resident
        as an evictable prefix-cache entry (when registered) or returns
        to the free list."""
        left = self._ref[bid] - 1
        if left > 0:
            self._ref[bid] = left
            return
        del self._ref[bid]
        if bid in self._hash_of or bid in self._pinned:
            # Registered content stays discoverable; a pinned partial
            # block (directory tail payload source) stays resident even
            # though it has no chain hash — both sit in the LRU, and
            # eviction skips pinned entries.
            self._lru[bid] = None
            self._lru.move_to_end(bid)
        else:
            self._free.append(bid)
        self.stats["freed"] += 1

    def refcount(self, bid: int) -> int:
        return self._ref.get(bid, 0)

    # -- directory pins ----------------------------------------------------

    def pin(self, bid: int) -> None:
        """Exempt ``bid`` from eviction and free-list recycling: the
        fleet-wide prefix directory maps this block, possibly from
        another replica. Pin while the block is resident (referenced or
        cached); the pin survives the refcount reaching zero."""
        if bid == TRASH_BLOCK:
            raise ValueError("cannot pin the trash sink")
        if bid not in self._ref and bid not in self._lru:
            raise KeyError(f"block {bid} is not resident")
        self._pinned.add(bid)

    def unpin(self, bid: int) -> None:
        """Release a directory pin. An unpinned zero-ref block becomes
        evictable again (registered) or returns to the free list
        (unregistered partial block)."""
        self._pinned.discard(bid)
        if bid in self._lru and bid not in self._hash_of:
            del self._lru[bid]
            self._free.append(bid)

    def pinned(self, bid: int) -> bool:
        return bid in self._pinned

    def ensure_private(self, bid: int) -> int:
        """Copy-on-write entry point: return a block id the caller may
        freely overwrite. A block referenced only by the caller and not
        registered is returned as-is; a registered-but-exclusive block
        is unregistered (its cached content is about to change); a
        *shared* block is released (refcount--) and replaced by a fresh
        block — the caller is about to rewrite the content wholesale,
        so no device copy is needed."""
        if self._ref.get(bid, 0) <= 1:
            h = self._hash_of.pop(bid, None)
            if h is not None:
                self._by_hash.pop(h, None)
            return bid
        self.decref(bid)
        new = self.alloc(1)[0]
        self.stats["cow"] += 1
        return new

    # -- prefix cache ------------------------------------------------------

    def peek_prefix(self, tokens: np.ndarray, max_tokens: int) -> int:
        """How many leading FULL blocks of ``tokens`` (covering at most
        ``max_tokens`` tokens) the cache currently holds — no refcount
        side effects; admission gating uses this to size the true need."""
        n = 0
        for h in hash_prefix_chain(tokens, self.block_size):
            if (n + 1) * self.block_size > max_tokens:
                break
            if h not in self._by_hash:
                break
            n += 1
        return n

    def match_prefix(self, tokens: np.ndarray, max_tokens: int) -> List[int]:
        """Longest cached chain of leading full blocks (covering at most
        ``max_tokens`` tokens). Matched blocks are referenced (revived
        out of the LRU when needed) and returned in logical order."""
        matched: List[int] = []
        for h in hash_prefix_chain(tokens, self.block_size):
            if (len(matched) + 1) * self.block_size > max_tokens:
                break
            bid = self._by_hash.get(h)
            if bid is None:
                break
            if bid in self._ref:
                self.incref(bid)
            else:  # revive from the evictable cache
                self._lru.pop(bid, None)
                self._ref[bid] = 1
            matched.append(bid)
        if matched:
            self.stats["prefix_hit_blocks"] += len(matched)
            self.stats["prefix_hit_requests"] += 1
            self.stats["peak_live"] = max(
                self.stats["peak_live"], len(self._ref)
            )
        return matched

    def release_match(self, block_ids: Sequence[int]) -> None:
        """Undo a ``match_prefix`` (admission failed after matching)."""
        for bid in block_ids:
            self.decref(bid)

    def register_prefix(
        self, tokens: np.ndarray, block_ids: Sequence[int]
    ) -> int:
        """Make the full prompt blocks of ``tokens`` (physically
        ``block_ids[k]`` for logical block k) discoverable by later
        requests. First writer wins: a hash already mapped keeps its
        existing block. Returns how many new registrations were made."""
        new = 0
        for k, h in enumerate(hash_prefix_chain(tokens, self.block_size)):
            if k >= len(block_ids):
                break
            bid = int(block_ids[k])
            if h in self._by_hash or bid in self._hash_of:
                continue
            self._by_hash[h] = bid
            self._hash_of[bid] = h
            new += 1
        self.stats["registered"] += new
        return new

    def snapshot(self) -> Dict[str, int]:
        """Pool gauges for the obs bus / bench records."""
        return {
            "capacity": self.capacity,
            "free": self.free_count,
            "live": self.live_count,
            "cached": len(self._lru),
            "pinned": len(self._pinned),
            **self.stats,
        }


def prompt_key(tokens: np.ndarray) -> bytes:
    """Directory key for a *whole* prompt (full and partial blocks):
    one hash over every token, position-dependent by construction."""
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    return hashlib.sha1(toks.tobytes()).digest()


class PrefixDirectory:
    """Fleet-wide prefix directory: which replica holds which prefilled
    KV blocks, keyed by the same position-dependent content-hash chains
    the per-replica prefix cache uses (:func:`hash_prefix_chain`).

    Pure host-side metadata plus host-staged block payloads — the
    directory never touches a device or an allocator. The Router is the
    only writer: it publishes after a prefill replica exports a slot
    (the exporter pinned the blocks first, so every ``(rid, bid)`` the
    directory maps stays resident on that replica), serves **adoptions**
    (a second consumer of an identical greedy prompt seats decode state
    straight from the entry — zero prefill-program executions), serves
    **chain prefetches** (a different prompt sharing a full-block prefix
    imports just those blocks into its target replica's local cache),
    and re-homes or drops entries when a holder replica dies.

    Entries are published only for greedy (``temperature == 0.0``)
    requests: the entry carries the deterministic first token, which is
    what makes adoption a pure state transplant. Payloads are staged on
    host at export time, so no cross-thread device read ever races a
    replica's pump writing its pool.

    Refcount surface (``tests/test_serving_disagg.py`` ledger oracle):
    ``holders`` maps ``rid -> [bid, ...]`` per entry — every mapped
    block is pinned on that replica; ``drop_replica`` re-homes the
    owner to a surviving holder or drops the entry, and ``clear``
    returns every pin so allocator ledgers balance at teardown.
    """

    def __init__(self) -> None:
        # prompt_key -> entry dict (see publish()).
        self._entries: Dict[bytes, Dict] = {}
        # chain hash -> (prompt_key, block index) for full-block
        # prefix lookups across entries.
        self._chains: Dict[bytes, Tuple[bytes, int]] = {}
        self.stats = {
            "publishes": 0, "lookups": 0, "hits": 0,
            "chain_hits": 0, "rehomed": 0, "dropped": 0,
        }

    def __len__(self) -> int:
        return len(self._entries)

    # -- publish -----------------------------------------------------------

    def publish(
        self,
        rid: int,
        prompt: np.ndarray,
        block_ids: Sequence[int],
        payload: Dict,
        *,
        first_token: int,
        block_size: int,
    ) -> bool:
        """Record that replica ``rid`` holds the prefilled blocks of
        ``prompt`` (``block_ids`` in logical order, covering every
        written position — the tail entry may be a partial block).
        ``payload`` is the host-staged block content (leaf-path ->
        ``[len(block_ids), block_size, ...]`` numpy). First writer
        wins; a later publish of the same prompt adds ``rid`` as
        another holder. Returns True when ``rid`` became a holder
        (caller keeps its pins), False when the publish was a no-op
        (caller should unpin)."""
        toks = np.ascontiguousarray(np.asarray(prompt, np.int32))
        key = prompt_key(toks)
        ent = self._entries.get(key)
        if ent is not None:
            if rid in ent["holders"]:
                return False
            ent["holders"][rid] = [int(b) for b in block_ids]
            self.stats["publishes"] += 1
            return True
        ent = {
            "prompt": toks.copy(),
            "owner": int(rid),
            "holders": {int(rid): [int(b) for b in block_ids]},
            "payload": payload,
            "first_token": int(first_token),
            "block_size": int(block_size),
            "adoptions": 0,
        }
        self._entries[key] = ent
        for k, h in enumerate(hash_prefix_chain(toks, block_size)):
            if k >= len(block_ids):
                break
            self._chains.setdefault(h, (key, k))
        self.stats["publishes"] += 1
        return True

    # -- lookup ------------------------------------------------------------

    def lookup(self, prompt: np.ndarray) -> Optional[Dict]:
        """Exact whole-prompt entry (adoption candidate) or None."""
        self.stats["lookups"] += 1
        ent = self._entries.get(prompt_key(prompt))
        if ent is not None:
            self.stats["hits"] += 1
        return ent

    def adopt(self, prompt: np.ndarray) -> Optional[Dict]:
        """:meth:`lookup` that also counts an adoption on the entry."""
        ent = self.lookup(prompt)
        if ent is not None:
            ent["adoptions"] += 1
        return ent

    def lookup_chain(
        self, prompt: np.ndarray, block_size: int
    ) -> Tuple[int, Optional[Dict], Dict]:
        """Longest directory-held chain of leading FULL blocks of
        ``prompt``. Returns ``(n_blocks, entry, payload_slice)`` where
        ``payload_slice`` maps leaf path -> the first ``n_blocks`` rows
        of the holding entry's payload (host numpy). ``(0, None, {})``
        on a miss or block-size mismatch."""
        chain = hash_prefix_chain(prompt, block_size)
        n = 0
        ref: Optional[Tuple[bytes, int]] = None
        for k, h in enumerate(chain):
            hit = self._chains.get(h)
            if hit is None:
                break
            ref = hit
            n += 1
        if n == 0 or ref is None:
            return 0, None, {}
        ent = self._entries.get(ref[0])
        if ent is None or ent["block_size"] != block_size:
            return 0, None, {}
        self.stats["chain_hits"] += 1
        sliced = {p: a[:n] for p, a in ent["payload"].items()}
        return n, ent, sliced

    # -- membership --------------------------------------------------------

    def drop_replica(self, rid: int) -> List[Tuple[int, List[int]]]:
        """Forget every block ``rid`` held (replica failed/removed).
        Entries re-home to a surviving holder; an entry with no holder
        left is dropped (its chain hashes too). Returns the
        ``(rid, block_ids)`` pairs that were unmapped so a caller with
        a live replica (drain path) can unpin them."""
        unmapped: List[Tuple[int, List[int]]] = []
        dead: List[bytes] = []
        for key, ent in self._entries.items():
            bids = ent["holders"].pop(rid, None)
            if bids is None:
                continue
            unmapped.append((rid, bids))
            if not ent["holders"]:
                dead.append(key)
            elif ent["owner"] == rid:
                ent["owner"] = next(iter(ent["holders"]))
                self.stats["rehomed"] += 1
        for key in dead:
            ent = self._entries.pop(key)
            self._chains = {
                h: ref for h, ref in self._chains.items() if ref[0] != key
            }
            self.stats["dropped"] += 1
        return unmapped

    def mapped_blocks(self, rid: int) -> List[int]:
        """Every block id the directory maps on ``rid`` (test oracle:
        each must be pinned + resident there)."""
        out: List[int] = []
        for ent in self._entries.values():
            out.extend(ent["holders"].get(rid, []))
        return out

    def clear(self) -> List[Tuple[int, List[int]]]:
        """Drop every entry, returning all ``(rid, block_ids)``
        mappings so the caller can unpin them (teardown ledger
        balance)."""
        out: List[Tuple[int, List[int]]] = []
        for ent in self._entries.values():
            for rid, bids in ent["holders"].items():
                out.append((int(rid), list(bids)))
        self._entries.clear()
        self._chains.clear()
        return out

    def snapshot(self) -> Dict[str, int]:
        return {
            "entries": len(self._entries),
            "chains": len(self._chains),
            **self.stats,
        }
