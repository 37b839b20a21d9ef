"""Block-pool KV memory: the host-side allocator behind the paged cache
(own copy of the reference's ``serve/blocks.py``; host-only Python).

One pool owns ``num_blocks`` interchangeable KV blocks of ``block_size``
tokens each (the device tensors live in the engine as
``model.init_paged_cache(num_blocks, block_size)`` — shape
``(L, num_blocks, block_size, Hkv, hd)`` per leaf). A sequence's KV is
scattered over whichever physical blocks were free at admission/growth
time; logical token ``j`` of a slot lives at
``(table[j // block_size], j % block_size)``. Contiguity is never
required, so there is no external fragmentation: any free block
satisfies any allocation, and the only waste is the tail of a
sequence's last block (< ``block_size`` tokens per sequence).

Physical block 0 is **reserved as scratch** and never handed out:
engine slots that are inactive (or parked on pool exhaustion) still
ride through the batched decode step, and their K/V scatter lands in
block 0 via their zeroed table entries instead of corrupting a block
owned by a live sequence. Scratch contents are garbage by design and
are never read by an owned slot (every owned position maps to an
allocated block).

**Reference counting + prefix index (copy-on-write sharing).** A block
may be held by several owners at once: ``alloc`` mints a block at
refcount 1, ``acquire`` adds a holder, ``free`` drops one — the block
returns to the pool only when its last holder lets go, so a shared
block occupies pool memory (and ``used``/``occupancy`` accounting)
exactly once. A freed block's index entry survives as a **cached**
block until ``alloc`` recycles the memory (unindexed blocks are handed
out first): a later same-prefix admission ``acquire``s it back off the
free list — content untouched — so sequential same-template requests
share, not just overlapping ones. On top of the refcounts sits a **prefix index** keyed by
token content: ``register`` records "this block holds these tokens,
chained after that block", and ``match`` walks a new prompt through
the index block by block so admission can ``acquire`` the resident
copy instead of recomputing and re-storing it. Chain links are
(parent block, token tuple) — the parent's identity pins everything
before it, Python dict hashing of the block-sized tuple *is* the
token-hash, and comparing tuples on collision keeps matches exact
rather than probabilistic; one match walk is O(prompt).

Sharing changes the write contract: a block is **writable only at
refcount 1**. Appending into a shared block must copy-on-write first
(the engine owns the device-side copy; the pool just answers
``writable`` and hands out the fresh block), and any in-place write
below a block's registered extent must ``prepare_write`` so the index
stops advertising content that is about to change.

The allocator tracks holders per block purely to make double-free /
foreign-free / double-hold a hard error (and testable as a property)
rather than a silent cross-sequence KV corruption.
"""
from __future__ import annotations

from repro_torch.serve.telemetry import NOOP, PID_POOL

SCRATCH_BLOCK = 0


def blocks_for_tokens(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` (ceil division; 0 -> 0)."""
    return -(-n_tokens // block_size)


class BlockPool:
    """All-or-nothing allocator over interchangeable, refcounted KV blocks.

    ``total`` excludes the reserved scratch block; ``alloc`` returns the
    physical block ids or ``None`` when the pool cannot satisfy the
    request (the caller parks / sheds — partial grants would deadlock
    admission). Freed blocks go back LIFO so recently-touched device
    memory is reused first.
    """

    def __init__(self, num_blocks: int, block_size: int, *, tracer=None):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is scratch)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # event recorder (serve/telemetry.py): alloc/free/revive
        # instants + an occupancy counter track, all guarded on
        # .enabled so the untraced allocator stays allocation-free
        self.tracer = NOOP if tracer is None else tracer
        # monotonic mutation stamp: bumped by every state change that
        # could alter a prefix match or an admission cost (alloc, free,
        # acquire, register, deregister). The scheduler's plan-ahead
        # stamps its precomputed admission costs with this and re-walks
        # only when the pool actually moved underneath the plan.
        self.version = 0
        self._free = list(range(num_blocks - 1, 0, -1))   # LIFO, 0 reserved
        self._holders: dict[int, list] = {}               # block -> holders
        # prefix index, chained by PARENT BLOCK rather than keyed by the
        # whole token prefix: a registered block's identity pins its
        # content and (recursively) everything before it, so one match
        # step costs O(block_size) token compares instead of hashing an
        # O(position) prefix tuple — pool.match is O(P), not O(P^2),
        # which matters because the scheduler's fill/shed loops call
        # blocks_needed per queued request per tick.
        self._block_key: dict[int, tuple] = {}    # block -> (parent, tokens)
        self._children: dict[object, list[int]] = {}   # parent -> blocks

    # ------------------------------------------------------------ queries
    @property
    def total(self) -> int:
        """Allocatable blocks (scratch excluded)."""
        return self.num_blocks - 1

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        """Physical blocks held by >= 1 owner — a shared block counts
        once, however many sequences read it."""
        return self.total - len(self._free)

    @property
    def shared(self) -> int:
        """Blocks currently held by more than one owner."""
        return sum(1 for h in self._holders.values() if len(h) > 1)

    @property
    def occupancy(self) -> float:
        """Fraction of the pool in use, in [0, 1]."""
        return self.used / self.total if self.total else 1.0

    @property
    def cached(self) -> int:
        """Free blocks whose prefix-index entry is still alive — content
        reusable by a future match until ``alloc`` recycles them."""
        return sum(1 for b in self._block_key if b not in self._holders)

    def blocks_for(self, n_tokens: int) -> int:
        return blocks_for_tokens(n_tokens, self.block_size)

    def owner_of(self, block: int):
        """Sole holder of ``block`` (or a tuple of holders when shared)."""
        holders = self._holders.get(block)
        if holders is None:
            return None
        return holders[0] if len(holders) == 1 else tuple(holders)

    def refcount(self, block: int) -> int:
        return len(self._holders.get(block, ()))

    def writable(self, block: int) -> bool:
        """In-place writes are legal only for a sole holder; a shared
        block must be copy-on-written first."""
        return self.refcount(block) == 1

    # --------------------------------------------------------- alloc/free
    def alloc(self, n: int, owner) -> list | None:
        """Take ``n`` fresh blocks (refcount 1) for ``owner``; None if
        fewer are free. Free blocks still carrying a **cached** prefix
        entry (see :meth:`free`) are handed out last — and evicted from
        the index the moment they are, so the index never advertises
        content about to be overwritten."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        got: list = []
        evicted = 0
        # LIFO over unindexed blocks first: recently-touched memory is
        # reused AND resident cached prefixes survive as long as any
        # uncached block can serve the allocation
        for i in range(len(self._free) - 1, -1, -1):
            if len(got) == n:
                break
            if self._free[i] not in self._block_key:
                got.append(self._free.pop(i))
        while len(got) < n:                  # evict coldest cached entries
            b = self._free.pop(0)
            self.deregister(b)
            got.append(b)
            evicted += 1
        for b in got:
            self._holders[b] = [owner]
        self.version += 1
        if n and self.tracer.enabled:
            self._trace("alloc", {"n": n, "owner": str(owner),
                                  "cached_evicted": evicted})
        return got

    def acquire(self, block: int, owner) -> None:
        """Add ``owner`` as a holder of ``block``. The block is either
        resident (prefix sharing between live sequences) or a **cached
        free** block still advertised by the index — the latter is
        *revived*: pulled off the free list with ``owner`` as its sole
        holder, its device content untouched since the last free (only
        ``alloc`` recycles content, and it deregisters first). Double-
        hold is a hard error — no table maps the same physical block
        twice for one sequence."""
        holders = self._holders.get(block)
        if holders is None:
            if block in self._block_key:
                self._free.remove(block)     # revive a cached prefix block
                self._holders[block] = [owner]
                self.version += 1
                if self.tracer.enabled:
                    self._trace("revive", {"block": int(block),
                                           "owner": str(owner)})
                return
            raise ValueError(f"block {block}: acquire of a free block")
        if owner in holders:
            raise ValueError(f"block {block}: {owner!r} already holds it")
        holders.append(owner)
        self.version += 1
        if self.tracer.enabled:
            self._trace("share", {"block": int(block),
                                  "holders": len(holders)})

    def free(self, blocks: list, owner) -> None:
        """Drop ``owner``'s hold on each of ``blocks``; a block returns
        to the pool when its last holder lets go — but its prefix-index
        entry **stays alive** (a *cached* block) until ``alloc`` hands
        the memory back out, so a later same-template request can still
        match and revive it (sequential sharing, not just overlapping
        arrivals). Double-free or a free of someone else's block fails
        loudly."""
        released = 0
        for b in blocks:
            holders = self._holders.get(b)
            if holders is None:
                raise ValueError(f"block {b}: freed but not allocated")
            if owner not in holders:
                raise ValueError(f"block {b}: owned by {holders!r}, "
                                 f"freed by {owner!r}")
            holders.remove(owner)
            if not holders:
                del self._holders[b]
                self._free.append(b)
                released += 1
        self.version += 1
        if blocks and self.tracer.enabled:
            self._trace("free", {"n": len(blocks), "released": released,
                                 "owner": str(owner)})

    # ------------------------------------------------------- prefix index
    ROOT = None        # parent of a sequence's first block

    def register(self, block: int, parent, tokens: tuple):
        """Advertise that resident ``block`` holds ``tokens`` (its first
        ``len(tokens)`` positions), chained after registered block
        ``parent`` (``ROOT`` for the first block of a prompt). Returns
        the **canonical** block for this chain position — ``block``
        itself, or the already-registered equivalent when this content
        is a duplicate (callers thread the return value as the next
        block's parent so chains converge on one copy) — or None when
        the block cannot be indexed."""
        tokens = tuple(tokens)
        if not tokens or block not in self._holders:
            return None
        for other in self._children.get(parent, ()):
            if self._block_key[other][1] == tokens:
                return other                   # identical entry: keep first
        if block in self._block_key:
            return None                        # already indexed elsewhere
        self._block_key[block] = (parent, tokens)
        self._children.setdefault(parent, []).append(block)
        self.version += 1
        return block

    def deregister(self, block: int) -> None:
        """Drop ``block``'s index entry — and, recursively, any entries
        chained *after* it: a child's key names this block as parent, and
        once the parent id is recycled with new content a same-id
        re-registration would make those stale chains reachable again
        with the wrong tokens behind them."""
        key = self._block_key.pop(block, None)
        if key is None:
            return
        self.version += 1
        for child in list(self._children.get(block, ())):
            self.deregister(child)
        bucket = self._children[key[0]]
        bucket.remove(block)
        if not bucket:
            del self._children[key[0]]

    def registered_extent(self, block: int) -> int:
        """Tokens the index advertises for ``block`` (0 if unregistered)."""
        key = self._block_key.get(block)
        return len(key[1]) if key else 0

    def prepare_write(self, block: int, offset: int) -> None:
        """Must be called before an in-place write at token ``offset`` of
        ``block``: a write below the registered extent invalidates what
        the index advertises, so the entry is dropped. Writes at or past
        the extent (appends into the unregistered tail) keep it."""
        if not self.writable(block):
            raise ValueError(f"block {block}: write while shared "
                             f"(refcount {self.refcount(block)})")
        if offset < self.registered_extent(block):
            self.deregister(block)

    def lookup(self, parent, chunk: tuple, *,
               partial: bool = False) -> int | None:
        """A resident block chained after ``parent`` whose content is
        ``chunk`` (or, with ``partial``, *starts with* ``chunk``)."""
        if not chunk:
            return None
        chunk = tuple(chunk)
        for b in self._children.get(parent, ()):
            tokens = self._block_key[b][1]
            if tokens == chunk or \
                    (partial and len(tokens) >= len(chunk)
                     and tokens[:len(chunk)] == chunk):
                return b
        return None

    def match(self, tokens, max_len: int | None = None):
        """Longest indexed prefix of ``tokens`` (capped at ``max_len``):
        returns ``(blocks, matched)`` where ``blocks`` are the resident
        blocks covering tokens ``[0, matched)`` in logical order. Walks
        full ``block_size`` chunks down the parent chain, then tries one
        partial tail chunk (shared-tail reuse — the caller copy-on-writes
        before it ever appends there). Pure query: acquires nothing."""
        if not self._block_key:
            return [], 0                       # empty index: free fast path
        tokens = list(tokens)
        if max_len is None:
            max_len = len(tokens)
        max_len = min(max_len, len(tokens))
        bs = self.block_size
        blocks: list = []
        parent = self.ROOT
        pos = 0
        while pos + bs <= max_len:
            b = self.lookup(parent, tuple(tokens[pos:pos + bs]))
            if b is None:
                break
            blocks.append(b)
            parent = b
            pos += bs
        tail = tuple(tokens[pos:max_len])
        if tail:
            b = self.lookup(parent, tail, partial=True)
            if b is not None:
                blocks.append(b)
                pos += len(tail)
        return blocks, pos

    # ---------------------------------------------------------- telemetry
    def _trace(self, name: str, args: dict) -> None:
        """One pool mutation on the trace: the event itself plus an
        occupancy counter sample, so Perfetto draws used/shared/cached
        as a filled track alongside the request and tick spans."""
        self.tracer.instant(name, pid=PID_POOL, args=args)
        self.tracer.counter("pool", {"used": self.used,
                                     "shared": self.shared,
                                     "cached": self.cached}, pid=PID_POOL)

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        return {"total": self.total, "used": self.used,
                "available": self.available, "occupancy": self.occupancy,
                "shared": self.shared, "indexed": len(self._block_key),
                "cached": self.cached, "block_size": self.block_size}

    def check(self) -> None:
        """Assert the allocator invariants (used by the property suite):
        accounting sums to the pool, holders are unique per block, the
        scratch block is never owned or free-listed, and the index only
        advertises resident or cached-free blocks, chained off parents
        that are themselves indexed (no dangling chains a recycled block
        id could resurrect)."""
        assert self.used + self.available == self.total, \
            (self.used, self.available, self.total)
        assert SCRATCH_BLOCK not in self._holders
        assert SCRATCH_BLOCK not in self._free
        assert len(set(self._free)) == len(self._free)
        for b, holders in self._holders.items():
            assert holders, b                        # refcount >= 1
            assert len(set(holders)) == len(holders), (b, holders)
            assert b not in self._free, b
        for b, (parent, tokens) in self._block_key.items():
            assert b in self._holders or b in self._free, \
                f"index advertises unknown block {b}"
            assert tokens, b
            assert parent is self.ROOT or parent in self._block_key, \
                f"block {b} chains off unindexed parent {parent}"
        for parent, bucket in self._children.items():
            for b in bucket:
                assert self._block_key[b][0] == parent
