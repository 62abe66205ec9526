"""Paged KV pool with a radix-tree prefix index (counterpart of
``fairness_llm_tpu/serving/paged.py``).

Counterfactual sweeps decode prompts that are byte-identical but for the
swapped demographic tokens, which come last. The non-paged scheduler gives
every admitted request a private ``cache_len`` row and prefills its whole
prompt; with ``ServingConfig.paged_kv`` the scheduler uses this module:

- **Block arena** (device): one pool of ``num_blocks`` fixed-size blocks per
  layer (``[N, block_size, n_kv, head_dim]`` k/v, int8 with f32
  ``[N, block_size, n_kv]`` scales under ``kv_cache_quant``, plus per-block
  ``key_valid``/``key_positions`` and per-slot ``lengths``). A request's KV
  lives in whatever blocks its table names, so prompt-prefix blocks can be
  shared between requests.
- **Block tables** (host, owned by :class:`PagedKV`, which ``SlotPool``
  carries): ``tables[slot] -> [nb]`` block ids covering the slot's logical
  extent ``[0, nb * block_size)``. The step functions gather the arena
  through the tables into a contiguous per-row view (block ``j`` covers
  positions ``[j*bs, (j+1)*bs)``), run the same attention as the non-paged
  path over it (the decode kernel reads the view), and scatter back only
  the rows' private blocks.
- **Radix index** (host): a trie over ``block_size``-token chunks of prompt
  token ids, each node owning one arena block with a refcount of the live
  slots using it. Admission matches the longest cached prefix (full
  blocks, plus a partial match of one more block resolved by
  copy-on-write), bumps refcounts, and prefills only the unmatched suffix.
  Release decrements; unreferenced nodes stay cached until the free list
  runs dry, then evict least recently used leaf first.

**The sink block.** The reference's scatters drop the entries that name
block ``num_blocks`` (write-table entries of shared blocks and dead rows,
rows without a copy-on-write, the ``key_valid`` clear of those entries):
XLA's ``mode="drop"``. PyTorch has no such scatter, and a boolean mask of
the entries to keep would need ``nonzero``, a host sync. So the arena
holds one more block, the sink at index ``num_blocks``: those writes land
there, every scatter is a plain ``index_copy_``/``index_fill_`` of fixed
shape, and no table ever reads the sink. ``num_blocks``, the free list and
every published count still say ``num_blocks``.

**Fixed buffers.** The view the step functions gather into is allocated
once per scheduler (``init_cache`` rows of ``blocks_per_slot *
block_size`` slots), and so are its table buffers; each chunk copies new
values into them, so the serve step keeps one shape.

Invalidation discipline (rows -> blocks): a freed block is only reachable
again through a table that includes it, and the prefill clears
``key_valid`` for every private block it writes before any gather reads
it, so a recycled block never shows its previous tenant's keys.

Positions are absolute (prefix tokens sit at positions ``0..``), so a
cached prefix is the same for every request that shares it, which is why
the radix index keys on token ids alone.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from fairness_llm_tpu_torch.models.configs import ModelConfig
from fairness_llm_tpu_torch.models.transformer import KVCache, LayerCache, init_cache
from fairness_llm_tpu_torch.telemetry import get_registry


# ---------------------------------------------------------------------------
# Device side: block arena + gather/scatter views
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BlockArena:
    """Device-resident paged KV state. ``layers[i].k/v`` are ``[N + 1,
    block_size, n_kv, head_dim]`` (int8 with per-vector scales under
    ``kv_cache_quant``, as ``LayerCache``), ``key_valid``/``key_positions``
    ``[N + 1, block_size]``; row N is the sink. ``lengths`` is per slot
    (the row's next position, not block state)."""

    layers: List[LayerCache]
    key_valid: torch.Tensor  # [N + 1, bs] bool
    key_positions: torch.Tensor  # [N + 1, bs] int64
    lengths: torch.Tensor  # [num_slots] int64

    @property
    def num_blocks(self) -> int:
        return self.key_valid.shape[0] - 1

    @property
    def block_size(self) -> int:
        return self.key_valid.shape[1]

    def tensors(self) -> List[torch.Tensor]:
        """Every per-block tensor (k, v, scales, key_positions; not
        ``key_valid``), the ones a block copy moves."""
        out = []
        for lc in self.layers:
            out += [lc.k, lc.v] + ([lc.k_scale, lc.v_scale] if lc.k_scale is not None else [])
        return out + [self.key_positions]

    def zero_(self) -> None:
        for t in self.tensors() + [self.key_valid, self.lengths]:
            t.zero_()


def init_arena(config: ModelConfig, num_blocks: int, block_size: int, num_slots: int,
               device=None, dtype: Optional[torch.dtype] = None) -> BlockArena:
    """A zeroed arena of ``num_blocks`` blocks and the sink."""
    c = init_cache(config, num_blocks + 1, block_size, dtype=dtype, device=device)
    return BlockArena(layers=c.layers, key_valid=c.key_valid, key_positions=c.key_positions,
                      lengths=torch.zeros((num_slots,), dtype=torch.long, device=device))


def _rows(buf: torch.Tensor, B: int, nb: int) -> torch.Tensor:
    """The first ``B`` rows of a ``[rows, nb*bs, ...]`` view buffer as
    ``[B*nb, bs, ...]`` blocks (a view: writes land in the buffer)."""
    return buf[:B].view((B * nb, buf.shape[1] // nb) + tuple(buf.shape[2:]))


def gather_view(arena: BlockArena, tables: torch.Tensor, lengths: torch.Tensor,
                out: KVCache) -> KVCache:
    """Copy each row's blocks into the first ``B`` rows of the view buffer
    ``out`` (``tables`` ``[B, nb]`` long; row b's slot ``j*bs + i`` is block
    ``tables[b, j]``'s slot i) and return those rows as a ``KVCache``
    whose ``lengths`` is ``lengths``. One gather per chunk, not per step:
    the chunk's writes scatter back once at its end."""
    B, nb = tables.shape
    idx = tables.reshape(-1)

    def g(src, dst):
        torch.index_select(src, 0, idx, out=_rows(dst, B, nb))
        return dst[:B]

    layers = []
    for lc, vc in zip(arena.layers, out.layers):
        kw = dict(k=g(lc.k, vc.k), v=g(lc.v, vc.v))
        if lc.k_scale is not None:
            kw.update(k_scale=g(lc.k_scale, vc.k_scale), v_scale=g(lc.v_scale, vc.v_scale))
        layers.append(LayerCache(**kw))
    return KVCache(layers=layers, key_valid=g(arena.key_valid, out.key_valid),
                   key_positions=g(arena.key_positions, out.key_positions), index=0,
                   lengths=lengths)


def scatter_view(arena: BlockArena, view: KVCache, write_tables: torch.Tensor) -> None:
    """Write a view's blocks back into the arena through ``write_tables``
    (``[B, nb]`` long, ``B`` the view's rows). Entries equal to
    ``num_blocks`` land in the sink: that is how shared blocks and dead rows
    stay read-only. Among the other entries every block id belongs to one
    row (the allocator's invariant), so no two writes meet. ``lengths`` is
    not written here."""
    B, nb = write_tables.shape
    idx = write_tables.reshape(-1)

    def s(big, small):
        big.index_copy_(0, idx, _rows(small, B, nb))

    for big, small in zip(arena.layers, view.layers):
        s(big.k, small.k)
        s(big.v, small.v)
        if big.k_scale is not None:
            s(big.k_scale, small.k_scale)
            s(big.v_scale, small.v_scale)
    s(arena.key_valid, view.key_valid)
    s(arena.key_positions, view.key_positions)


# ---------------------------------------------------------------------------
# Host side: radix-tree prefix index
# ---------------------------------------------------------------------------


class RadixNode:
    """One cached full block: exactly ``block_size`` token ids, one arena
    block, a refcount of live slots currently reading it, and an LRU stamp
    (a logical counter — deterministic, no wall clock)."""

    __slots__ = ("tokens", "block", "children", "parent", "refs", "last_use")

    def __init__(self, tokens: Tuple[int, ...], block: int,
                 parent: Optional["RadixNode"]):
        self.tokens = tokens
        self.block = block
        self.children: Dict[Tuple[int, ...], RadixNode] = {}
        self.parent = parent
        self.refs = 0
        self.last_use = 0


@dataclasses.dataclass
class PrefixMatch:
    """Result of a radix lookup for one prompt.

    ``nodes``: matched full-block chain from the root (refcounts already
    bumped — the caller owns them until ``release``). ``cow_node`` /
    ``cow_len``: when the NEXT block matches partially, the node whose
    arena block to copy-on-write from and how many of its leading tokens
    are shared (the divergence point sits inside it; the source is never
    mutated). The CoW node is ALSO refcount-pinned by ``match`` — between
    planning and the device copy, another admission's eviction must not
    free and reallocate the source block (it would be silently rewritten
    before the copy reads it). The pin drops at ``commit`` (copy done) or
    ``release``. ``matched``: reused tokens = ``len(nodes)*bs + cow_len``.
    """

    nodes: List[RadixNode]
    cow_node: Optional[RadixNode]
    cow_len: int

    @property
    def cow_src_block(self) -> Optional[int]:
        return self.cow_node.block if self.cow_node is not None else None

    def matched(self, block_size: int) -> int:
        return len(self.nodes) * block_size + self.cow_len


class RadixIndex:
    """Host trie over ``block_size``-token chunks, refcounted, LRU-evictable.

    Only FULL prompt blocks are ever inserted (a block holding the tail of a
    prompt plus decode tokens is private to its request forever), so every
    node carries exactly ``block_size`` tokens and children key on the full
    chunk tuple. Matching walks whole chunks, then resolves one partial
    chunk against the current children for copy-on-write.
    """

    def __init__(self, block_size: int):
        self.block_size = block_size
        self.root = RadixNode((), -1, None)  # sentinel, owns no block
        self._clock = 0
        self._nodes = 0  # excluding the root
        self._unref = 0  # nodes with refs == 0 (incremental: the cached-
        # blocks gauge publishes per admit/release, and a full-trie DFS
        # there would make the admission hot path O(tree size))

    def __len__(self) -> int:
        return self._nodes

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _ref(self, node: RadixNode) -> None:
        if node.refs == 0:
            self._unref -= 1
        node.refs += 1

    def _deref(self, node: RadixNode) -> None:
        node.refs -= 1
        assert node.refs >= 0, "radix refcount went negative"
        if node.refs == 0:
            self._unref += 1

    def match(self, ids: List[int]) -> PrefixMatch:
        """Longest cached prefix of ``ids``, capped at ``len(ids) - 1``
        (at least one token must prefill so the request has last-token
        logits to sample from). Bumps refcounts on the matched chain."""
        bs = self.block_size
        max_match = max(0, len(ids) - 1)
        node = self.root
        nodes: List[RadixNode] = []
        k = 0
        while (k + 1) * bs <= max_match:
            child = node.children.get(tuple(ids[k * bs:(k + 1) * bs]))
            if child is None:
                break
            nodes.append(child)
            node = child
            k += 1
        stamp = self._tick()
        for n in nodes:
            self._ref(n)
            n.last_use = stamp
        # Partial continuation for copy-on-write: among the current node's
        # children, the one sharing the longest nonzero lead of the
        # remaining ids. Deterministic tie-break on token tuple order.
        rem_budget = max_match - k * bs
        best_len, best_node = 0, None
        if rem_budget > 0:
            tail = ids[k * bs:k * bs + bs]
            for key in sorted(node.children):
                child = node.children[key]
                n_common = 0
                for a, b in zip(key, tail):
                    if a != b:
                        break
                    n_common += 1
                n_common = min(n_common, rem_budget)
                if n_common > best_len:
                    best_len, best_node = n_common, child
        if best_node is not None:
            # Pin the CoW source until the device copy lands (see
            # PrefixMatch): an unpinned source is an unreferenced node a
            # concurrent admission could LRU-evict and REWRITE first.
            self._ref(best_node)
            best_node.last_use = stamp
            return PrefixMatch(nodes, best_node, best_len)
        return PrefixMatch(nodes, None, 0)

    def insert(
        self, ids: List[int], blocks: List[int], matched_nodes: List[RadixNode]
    ) -> Tuple[List[RadixNode], List[int]]:
        """Register a freshly-prefilled prompt's full blocks. ``blocks`` are
        the slot's table entries; entries ``[len(matched_nodes),
        len(ids)//bs)`` hold newly-written full prompt blocks whose
        ownership transfers to the tree (they become shareable; the slot
        keeps a ref). Returns ``(held, promoted)``: the slot's full held
        chain (matched + promoted) for release-time deref, and the block
        ids actually transferred. A pre-existing child (the len-1 match cap
        can re-prefill tokens the tree already holds, via CoW) keeps the
        TREE's block; the caller's duplicate stays private and is NOT in
        ``promoted``."""
        bs = self.block_size
        node = matched_nodes[-1] if matched_nodes else self.root
        held = list(matched_nodes)
        promoted: List[int] = []
        stamp = self._tick()
        for k in range(len(matched_nodes), len(ids) // bs):
            chunk = tuple(ids[k * bs:(k + 1) * bs])
            child = node.children.get(chunk)
            if child is None:
                child = RadixNode(chunk, blocks[k], node)
                node.children[chunk] = child
                self._nodes += 1
                self._unref += 1  # born unreferenced; _ref below claims it
                promoted.append(blocks[k])
            self._ref(child)
            child.last_use = stamp
            held.append(child)
            node = child
        return held, promoted

    def release(self, held: List[RadixNode]) -> None:
        for n in held:
            self._deref(n)

    def evict_lru(self) -> Optional[int]:
        """Free the least-recently-used UNREFERENCED leaf, returning its
        arena block (the freed node's parent may become the next victim).
        None when every node is referenced or the tree is empty."""
        victim: Optional[RadixNode] = None
        stack = [self.root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                if child.children:
                    stack.append(child)
                elif child.refs == 0 and (
                    victim is None
                    or child.last_use < victim.last_use
                    or (child.last_use == victim.last_use
                        and child.block < victim.block)
                ):
                    victim = child
        if victim is None:
            return None
        del victim.parent.children[victim.tokens]
        self._nodes -= 1
        self._unref -= 1
        return victim.block

    def cached_blocks(self) -> int:
        """Nodes currently unreferenced (pure cache; a leaf subset of them
        is evictable right now, the rest as their subtrees drain)."""
        return self._unref


# ---------------------------------------------------------------------------
# The block manager SlotPool carries
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PagedAdmit:
    """Host-side plan for one paged admission row, consumed by the
    scheduler's paged prefill program."""

    matched: int  # reused prefix tokens (full blocks + CoW lead)
    table: List[int]  # the slot's full block table, [nb]
    write_table: List[int]  # table with shared entries -> num_blocks (the sink)
    cow_src: int  # arena block to copy from, or num_blocks (no CoW)
    cow_dst: int  # private block receiving the copy, or num_blocks


class PagedKV:
    """Block allocator + per-slot tables + radix index, one per scheduler.

    ``SlotPool`` owns an instance when the scheduler runs ``paged_kv`` and
    routes ``release`` through it, so admission, eviction and backfill
    (which only talk to the pool) compose unchanged.
    """

    def __init__(self, num_slots: int, blocks_per_slot: int,
                 block_size: int, num_blocks: Optional[int] = None,
                 labels: Optional[dict] = None):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_slots = num_slots
        self.blocks_per_slot = blocks_per_slot
        self.block_size = block_size
        # Default arena: every slot fully private (the zero-reuse worst
        # case) plus an equal reserve that survives as prefix cache.
        self.num_blocks = (num_blocks if num_blocks is not None
                          else 2 * num_slots * blocks_per_slot)
        if self.num_blocks < blocks_per_slot:
            raise ValueError(
                f"kv_blocks {self.num_blocks} cannot hold even one slot "
                f"({blocks_per_slot} blocks of {block_size} tokens)"
            )
        self._free: List[int] = list(range(self.num_blocks))
        self._free.reverse()  # pop() yields lowest id first — deterministic
        self.index = RadixIndex(block_size)
        self._tables: Dict[int, List[int]] = {}
        self._held: Dict[int, List[RadixNode]] = {}
        # Per-slot CoW-source pin (see PrefixMatch): held from admit until
        # commit (the device copy landed) or release/abort.
        self._cow: Dict[int, RadixNode] = {}
        self._private: Dict[int, List[int]] = {}
        self.labels = dict(labels or {})
        # Running hit/miss token totals for the live hit-ratio gauge (the
        # registry counters are process-wide; these are this pool's own).
        self._hit_tokens = 0
        self._miss_tokens = 0

    # -- accounting --------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def hit_ratio(self) -> float:
        total = self._hit_tokens + self._miss_tokens
        return (self._hit_tokens / total) if total else 0.0

    def _publish_gauges(self) -> None:
        reg = get_registry()
        reg.gauge("kv_blocks_free", component="paged_kv",
                  **self.labels).set(len(self._free))
        reg.gauge("kv_block_occupancy", component="paged_kv",
                  **self.labels).set(
            (self.num_blocks - len(self._free)) / self.num_blocks
        )
        reg.gauge("kv_blocks_cached", component="paged_kv",
                  **self.labels).set(self.index.cached_blocks())
        reg.gauge("prefix_cache_hit_ratio", component="paged_kv",
                  **self.labels).set(self.hit_ratio)

    def _alloc_blocks(self, n: int) -> Optional[List[int]]:
        """Claim ``n`` free blocks, evicting LRU unreferenced radix leaves
        as needed. None (nothing claimed) when even eviction cannot cover —
        the caller defers admission, exactly like a full slot pool."""
        evicted = 0
        while len(self._free) < n:
            block = self.index.evict_lru()
            if block is None:
                return None
            self._free.append(block)
            evicted += 1
        if evicted:
            get_registry().counter(
                "kv_blocks_evicted_total", component="paged_kv",
                **self.labels,
            ).inc(evicted)
        out = [self._free.pop() for _ in range(n)]
        return out

    # -- admission / release ----------------------------------------------

    def admit(self, slot: int, ids: List[int]) -> Optional[PagedAdmit]:
        """Plan one admission: match the radix index, allocate the private
        tail (evicting as needed), and build the slot's tables. None when
        blocks run dry (refcounts untouched; the request stays queued).

        The caller MUST follow a successful admit with either
        ``commit(slot, ids)`` after the prefill lands, or ``abort(slot)``
        when the prefill program faults.
        """
        assert slot not in self._tables, f"slot {slot} already has a table"
        bs = self.block_size
        m = self.index.match(ids)
        n_shared = len(m.nodes)
        n_private = self.blocks_per_slot - n_shared
        private = self._alloc_blocks(n_private)
        if private is None:
            # Nothing was claimed; drop the refs match() took (incl. the
            # CoW pin).
            self.index.release(m.nodes)
            if m.cow_node is not None:
                self.index.release([m.cow_node])
            return None
        table = [n.block for n in m.nodes] + private
        N = self.num_blocks
        write_table = [N] * n_shared + list(private)
        cow_src, cow_dst = N, N
        if m.cow_node is not None:  # match pins it only with cow_len > 0
            cow_src, cow_dst = m.cow_node.block, table[n_shared]
            self._cow[slot] = m.cow_node
            get_registry().counter(
                "prefix_cache_cow_total", component="paged_kv", **self.labels,
            ).inc()
        matched = m.matched(bs)
        self._tables[slot] = table
        self._held[slot] = m.nodes
        self._private[slot] = private
        reg = get_registry()
        miss = len(ids) - matched
        reg.counter("prefix_cache_hit_tokens_total", component="paged_kv",
                    **self.labels).inc(matched)
        reg.counter("prefix_cache_miss_tokens_total", component="paged_kv",
                    **self.labels).inc(miss)
        self._hit_tokens += matched
        self._miss_tokens += miss
        self._publish_gauges()
        return PagedAdmit(matched=matched, table=table,
                          write_table=write_table, cow_src=cow_src,
                          cow_dst=cow_dst)

    def commit(self, slot: int, ids: List[int]) -> None:
        """Prefill landed: promote the slot's full prompt blocks into the
        radix index (they are shareable from this moment on), and drop the
        CoW-source pin (the device copy has read it)."""
        cow = self._cow.pop(slot, None)
        if cow is not None:
            self.index.release([cow])
        held, promoted = self.index.insert(
            ids, self._tables[slot], self._held[slot]
        )
        self._held[slot] = held
        # Tree-owned blocks must not return to the free list at release.
        drop = set(promoted)
        self._private[slot] = [
            b for b in self._private[slot] if b not in drop
        ]

    def abort(self, slot: int) -> None:
        """Prefill faulted before ``commit``: undo ``admit`` entirely (the
        blocks hold garbage, but nothing references them and the next
        tenant's prefill clears their key_valid before exposure)."""
        self.release(slot)

    def release(self, slot: int) -> None:
        """Slot freed: deref the radix chain (nodes stay CACHED — that is
        the whole point) and return private blocks to the free list."""
        table = self._tables.pop(slot, None)
        if table is None:
            return  # slot was never paged-admitted (pad rows, double calls)
        self.index.release(self._held.pop(slot))
        cow = self._cow.pop(slot, None)
        if cow is not None:  # pre-commit abort: the pin is still held
            self.index.release([cow])
        self._free.extend(sorted(self._private.pop(slot), reverse=True))
        self._publish_gauges()

    def reset(self) -> None:
        """Arena rebuilt from zeros (after a failed decode chunk): every
        cached prefix is gone, so the index and tables must forget them
        too."""
        self.index = RadixIndex(self.block_size)
        self._tables.clear()
        self._held.clear()
        self._cow.clear()
        self._private.clear()
        self._free = list(range(self.num_blocks))
        self._free.reverse()
        self._publish_gauges()

    def table_for(self, slot: int) -> Optional[List[int]]:
        return self._tables.get(slot)

    def write_table_for(self, slot: int) -> List[int]:
        """Decode-time write mask: private blocks pass through, shared
        (tree-owned) entries go to the sink. Decode writes only ever land
        past the prompt, which lives in private blocks by construction — the
        sink entries are belt-and-braces against scatter of unmodified shared
        rows."""
        table = self._tables[slot]
        tree = {n.block for n in self._held[slot]}
        return [b if b not in tree else self.num_blocks for b in table]
