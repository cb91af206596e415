"""Refcounted KV-block pool with radix-trie prefix sharing.

The serving engine's paged block tables already indirect every cache
read through per-sequence block ids, so two sequences whose prompts
share a prefix can point their leading table entries at the SAME
physical blocks (vLLM's prefix caching / SGLang's radix attention).
This module owns the bookkeeping:

- every managed block carries a **refcount** (requests using it); the
  free list only holds blocks with no references and no trie entry;
- **full** ``block_size``-token prompt chunks are indexed in a radix
  trie keyed on the chunk's token tuple — matching a new prompt walks
  the trie chunk by chunk and hands back the shared blocks (incref'd),
  so prefill skips them entirely;
- a request finishing (EOS / cancel / error) **decrefs** instead of
  freeing: a block whose refcount hits zero but that is still indexed
  in the trie stays resident as reusable cache, and is evicted
  **LRU, leaves first**, only when an allocation actually needs the
  space (pool pressure) — an idle pool keeps every prefix warm.

Only full prompt chunks are ever inserted, which makes shared blocks
immutable by construction: a sequence's own writes (later prompt
chunks, generated tokens, speculative drafts) always land at positions
``>= matched_tokens``, i.e. in blocks the trie has never seen. The
partial tail of a fully-matched prompt is handled by the engine with a
copy-on-write block copy (see ``LLMEngine._admit``).

The port's copy of ``ray_tpu/serve/prefix_cache.py`` (the port imports
nothing from the JAX package).

Thread model: the pool is NOT internally locked — the engine calls it
with its scheduler lock held (all mutations happen on the step
thread).
"""

from __future__ import annotations

import collections
import zlib
from typing import Dict, List, Optional, Sequence, Tuple


def prefix_fingerprint(tokens: Sequence[int],
                       block_size: int) -> Optional[int]:
    """Stable fingerprint of a prompt's FIRST full KV-block chunk
    (crc32 of the token bytes — deterministic across processes, unlike
    ``hash``). ``None`` when the prompt has no full block. Routers
    compare this against :meth:`PrefixBlockPool.root_fingerprints` to
    place a COLD session on the replica whose radix trie already holds
    its prefix."""
    if block_size < 1 or len(tokens) < block_size:
        return None
    data = b"".join(int(t).to_bytes(8, "little", signed=True)
                    for t in tokens[:block_size])
    return zlib.crc32(data)


class _TrieNode:
    """One full token chunk in the radix trie. ``key`` is the chunk's
    token tuple (its edge label from ``parent``); ``block`` the
    physical block holding that chunk's KV."""

    __slots__ = ("children", "parent", "key", "block", "touch",
                 "detached", "hits")

    def __init__(self, parent: Optional["_TrieNode"],
                 key: Optional[tuple], block: Optional[int]):
        self.children: Dict[tuple, "_TrieNode"] = {}
        self.parent = parent
        self.key = key
        self.block = block
        self.touch = 0          # LRU clock stamp
        self.detached = False   # evicted — inserts under it must abort
        self.hits = 0           # prefix-match count (migration floor)


class PrefixBlockPool:
    """Refcounted block allocator + radix prefix index over one paged
    KV pool of ``num_blocks`` blocks (``reserved`` ids — the engine's
    trash block — are never handed out)."""

    def __init__(self, num_blocks: int, block_size: int,
                 reserved: Sequence[int] = (0,)):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.block_size = block_size
        self._reserved = frozenset(reserved)
        managed = [b for b in range(num_blocks)
                   if b not in self._reserved]
        self.total_managed = len(managed)
        self._free: "collections.deque[int]" = collections.deque(managed)
        self._ref: Dict[int, int] = {}          # block -> refcount >= 1
        self._node_of: Dict[int, _TrieNode] = {}  # trie-resident blocks
        self._root = _TrieNode(None, None, None)
        self._clock = 0
        # -- counters (engine surfaces these in stats())
        self.hits_total = 0        # blocks handed out via prefix match
        self.inserts_total = 0
        self.evictions_total = 0

    # ------------------------------------------------------- refcounts
    def incref(self, block: int) -> None:
        if block in self._ref:
            self._ref[block] += 1
        else:
            # resurrecting a cached (ref-0, trie-resident) block
            self._ref[block] = 1

    def decref(self, block: int) -> None:
        n = self._ref[block] - 1
        if n > 0:
            self._ref[block] = n
            return
        del self._ref[block]
        if block not in self._node_of:
            self._free.append(block)
        # else: stays resident in the trie as reusable cache

    def release(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            self.decref(b)

    # ------------------------------------------------------- matching
    def _touch(self, node: _TrieNode) -> None:
        self._clock += 1
        node.touch = self._clock

    def match_prefix(self, tokens: Sequence[int]
                     ) -> Tuple[List[int], int, _TrieNode]:
        """Walk the trie along ``tokens`` in full-chunk steps. Returns
        ``(blocks, matched_tokens, node)`` — matched blocks are
        incref'd (caller owns one reference each; release on abort) and
        ``node`` is the deepest matched trie node (the parent for this
        request's own inserts)."""
        node = self._root
        blocks: List[int] = []
        bs = self.block_size
        for i in range(len(tokens) // bs):
            child = node.children.get(tuple(tokens[i * bs:(i + 1) * bs]))
            if child is None:
                break
            node = child
            blocks.append(node.block)
            self.incref(node.block)
            self._touch(node)
            node.hits += 1
        # hits_total is NOT bumped here: a match may be released when
        # allocation fails (admission wait) and retried — the engine
        # counts hits once, on successful admission (count_hits)
        return blocks, len(blocks) * bs, node

    def count_hits(self, n: int) -> None:
        self.hits_total += n

    # ----------------------------------------------------- allocation
    def allocate(self, n: int) -> Optional[List[int]]:
        """Take ``n`` private blocks (refcount 1 each), evicting LRU
        ref-0 trie leaves under pressure. Returns None — with nothing
        taken — when even eviction can't cover ``n`` (the engine's
        admission-wait signal)."""
        got: List[int] = []
        while len(got) < n:
            if self._free:
                b = self._free.popleft()
                self._ref[b] = 1
                got.append(b)
                continue
            if not self._evict_one():
                for b in got:           # restore, all-or-nothing
                    del self._ref[b]
                    self._free.append(b)
                return None
        return got

    def _evict_one(self) -> bool:
        """Evict the least-recently-touched ref-0 LEAF (a node with
        referenced or cached children is load-bearing for deeper
        matches and never evicted; freeing a leaf may expose its
        parent as the next candidate)."""
        best: Optional[Tuple[int, _TrieNode]] = None
        for block, node in self._node_of.items():
            if block in self._ref or node.children:
                continue
            if best is None or node.touch < best[1].touch:
                best = (block, node)
        if best is None:
            return False
        block, node = best
        node.detached = True
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
        del self._node_of[block]
        self._free.append(block)
        self.evictions_total += 1
        return True

    # ------------------------------------------------------ insertion
    def insert_child(self, parent: Optional[_TrieNode],
                     chunk: Sequence[int], block: int
                     ) -> Tuple[Optional[_TrieNode], bool]:
        """Index ``block`` (full, holding exactly ``chunk``) under
        ``parent``. Returns ``(node, inserted)``:

        - fresh insert → the new node, True;
        - the path already exists (a concurrent request with the same
          prompt won the race) → the existing node, False — the
          caller's block stays private and is freed normally;
        - ``parent`` was evicted meanwhile (or None) → (None, False) —
          the caller stops indexing this request.
        """
        if parent is None or parent.detached:
            return None, False
        key = tuple(chunk)
        existing = parent.children.get(key)
        if existing is not None:
            self._touch(existing)
            return existing, False
        node = _TrieNode(parent, key, block)
        parent.children[key] = node
        self._node_of[block] = node
        self._touch(node)
        self.inserts_total += 1
        return node, True

    def drop_index(self) -> int:
        """Forget the whole prefix index, as when the weights that wrote
        its KV are replaced: cached (ref-0) blocks go back to the free
        list, referenced ones stay with their holders as private blocks,
        and inserts under any old node (the root included) abort.
        Returns the number of blocks the index held."""
        n = len(self._node_of)
        for block, node in self._node_of.items():
            node.detached = True
            if block not in self._ref:
                self._free.append(block)
        self._node_of.clear()
        self._root.detached = True
        self._root = _TrieNode(None, None, None)
        return n

    # ------------------------------------------------------- migration
    def export_chains(self, min_hits: int = 1,
                      max_blocks: int = 0) -> List[List[Tuple[tuple, int]]]:
        """Warm prefix chains worth migrating off a draining replica.

        A chain is a contiguous root-anchored trie path of ref-0
        (cached) nodes whose ``hits`` meet the floor — exactly the
        blocks that would die with this replica but have proven reuse.
        Chains truncate at the first node that is referenced (a live
        request still writes against it), below the hit floor, or
        detached: an importer re-inserts from its own root, so a gap
        would orphan everything deeper. Returns
        ``[[(chunk_tokens, block_id), ...], ...]`` ordered hottest
        chain first; ``max_blocks > 0`` caps the total block count.
        """
        chains: List[List[Tuple[tuple, int]]] = []

        def walk(node: _TrieNode, path: List[Tuple[tuple, int]]):
            extended = False
            for child in sorted(node.children.values(),
                                key=lambda n: -n.hits):
                if (child.detached or child.block in self._ref
                        or child.hits < min_hits):
                    continue
                walk(child, path + [(child.key, child.block)])
                extended = True
            if not extended and path:
                chains.append(path)

        walk(self._root, [])
        chains.sort(key=lambda c: -len(c))
        if max_blocks > 0:
            out, n = [], 0
            for c in chains:
                if n + len(c) > max_blocks:
                    c = c[:max_blocks - n]
                if not c:
                    break
                out.append(c)
                n += len(c)
            chains = out
        return chains

    # -------------------------------------------------------- introspection
    def root_fingerprints(self, limit: int = 64) -> List[int]:
        """Fingerprints of the trie ROOT's children — the first-block
        chunks this pool holds warm. O(root fan-out), capped at
        ``limit`` (most-recently-touched first): cheap enough for every
        ``Replica.stats()`` probe, rich enough for a router to place a
        cold session where its system prompt already lives."""
        kids = sorted(self._root.children.values(),
                      key=lambda n: -n.touch)[:limit]
        out = []
        for node in kids:
            fp = prefix_fingerprint(node.key, self.block_size)
            if fp is not None:
                out.append(fp)
        return out

    def stats(self) -> Dict[str, int]:
        cached = sum(1 for b in self._node_of if b not in self._ref)
        shared = sum(1 for b, r in self._ref.items() if r > 1)
        return {
            "free": len(self._free),
            "cached": cached,               # ref-0, trie-resident
            "reclaimable": len(self._free) + cached,
            "active": len(self._ref),
            "shared": shared,               # refcount > 1 right now
            "trie_blocks": len(self._node_of),
            "hits_total": self.hits_total,
            "inserts_total": self.inserts_total,
            "evictions_total": self.evictions_total,
        }

    def audit(self) -> List[str]:
        """Integrity check (leak regression tests): every managed block
        is in EXACTLY one of {free, referenced, cached-in-trie}; every
        trie node is reachable, attached, and consistent with
        ``_node_of``. Returns a list of problems (empty = clean)."""
        problems: List[str] = []
        free = set(self._free)
        if len(free) != len(self._free):
            problems.append("duplicate blocks on the free list")
        ref = set(self._ref)
        trie = set(self._node_of)
        if free & ref:
            problems.append(f"blocks both free and referenced: "
                            f"{sorted(free & ref)}")
        if free & trie:
            problems.append(f"blocks both free and trie-resident: "
                            f"{sorted(free & trie)}")
        accounted = free | ref | trie
        managed = {b for b in range(
            self.total_managed + len(self._reserved))
            if b not in self._reserved}
        missing = managed - accounted
        if missing:
            problems.append(f"leaked blocks (nowhere): {sorted(missing)}")
        extra = accounted - managed
        if extra:
            problems.append(f"unmanaged blocks tracked: {sorted(extra)}")
        # trie reachability + pointer consistency
        reachable = set()
        stack = [self._root]
        while stack:
            node = stack.pop()
            for key, child in node.children.items():
                if child.parent is not node or child.key != key:
                    problems.append(f"trie pointer mismatch at {key}")
                if child.detached:
                    problems.append(f"detached node still linked: {key}")
                if child.block is None:
                    problems.append(f"trie node without block: {key}")
                elif self._node_of.get(child.block) is not child:
                    problems.append(
                        f"_node_of mismatch for block {child.block}")
                else:
                    reachable.add(child.block)
                stack.append(child)
        dangling = trie - reachable
        if dangling:
            problems.append(f"unreachable trie blocks: {sorted(dangling)}")
        return problems
