"""Host-side paged KV cache manager.

The device side stores K/V in global page pools ``(Hkv, P, page_size, D)``
(one pool pair per attention layer, built by ``LM.init_paged_cache``);
this module owns the *bookkeeping*: a free list over physical pages and a
per-slot page table mapping logical KV block ``ki`` of the sequence in
decode slot ``b`` to its physical page.  ``page_size`` equals the decode
kernel's ``block_kv`` so one page table entry is exactly one kernel grid
step (the BlockSpec index map resolves ``ki -> table[b, ki]``).

Page 0 is reserved as a scratch page: idle decode slots keep an all-zero
table row and position 0, so their (ignored) writes land in scratch and
never touch pages owned by live sequences.

Pages carry **reference counts** so physical pages can be shared across
slots (prefix caching: several sequences with a common prompt prefix
read the same pages) and held by the radix prefix index after their
writer retires.  ``share_pages`` points an empty slot at already-resident
pages, ``incref``/``decref`` manage external (index) holds, and a page
only returns to the free list when its last reference drops.  Writes
stay safe via **copy-on-write**: ``append`` never writes into a
partially-filled tail page that is shared -- it moves the slot onto a
fresh copy first and records the (src, dst) pair in ``cow_pending`` so
the engine can replay the page copy on the device pools before the next
kernel launch.

All state is plain numpy/int -- allocation runs on host between device
steps, the device only ever sees the int32 table snapshot.
"""
from __future__ import annotations

import numpy as np


class OutOfPages(RuntimeError):
    """Raised when an append needs a page and the free list is empty."""


def pages_needed(cur_len: int, new_len: int, page_size: int) -> int:
    """Pages to allocate when growing a sequence cur_len -> new_len."""
    cur_pages = -(-cur_len // page_size)
    new_pages = -(-new_len // page_size)
    return max(0, new_pages - cur_pages)


class PagedKVCache:
    """Free-list + page-table manager for ``num_pages`` physical pages of
    ``page_size`` tokens across ``max_slots`` decode slots."""

    SCRATCH = 0          # physical page 0: idle-slot write target, never owned

    def __init__(self, num_pages: int, page_size: int, max_slots: int,
                 max_pages_per_seq: int, *, injector=None, metrics=None):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is scratch)")
        self.num_pages = num_pages
        # optional MetricsRegistry (serving/metrics.py): page allocations
        # and copy-on-write copies become cumulative counters
        self._c_alloc = (metrics.counter(
            "kv_pages_allocated_total",
            help="physical page allocations") if metrics is not None
            else None)
        self._c_cow = (metrics.counter(
            "kv_cow_copies_total",
            help="copy-on-write page copies") if metrics is not None
            else None)
        # optional FaultInjector (serving/faults.py): when armed, the
        # "page_alloc" site fires in append() BEFORE any mutation, so an
        # injected allocation fault leaves the cache untouched
        self.injector = injector
        self.page_size = page_size
        self.max_slots = max_slots
        self.max_pages_per_seq = max_pages_per_seq
        # LIFO free list: recently freed pages are recycled first (their
        # contents are most likely still resident in any cache hierarchy).
        self._free = list(range(num_pages - 1, 0, -1))
        self._pages: list = [[] for _ in range(max_slots)]
        self._lens = np.zeros((max_slots,), np.int64)
        self._active = np.zeros((max_slots,), bool)
        self.table = np.zeros((max_slots, max_pages_per_seq), np.int32)
        self.peak_used_pages = 0
        # per-page reference count: one per slot listing the page plus one
        # per external hold (prefix index).  Free pages are 0; scratch is
        # never refcounted.
        self._ref = np.zeros((num_pages,), np.int64)
        # copy-on-write debts: (src, dst) physical page pairs whose
        # device contents the engine must copy before the next launch
        # that reads or writes dst.
        self.cow_pending: list = []

    # -- introspection -------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def seq_len(self, slot: int) -> int:
        return int(self._lens[slot])

    def seq_lens(self) -> np.ndarray:
        return self._lens.copy()

    def is_active(self, slot: int) -> bool:
        return bool(self._active[slot])

    def owned_pages(self, slot: int) -> list:
        return list(self._pages[slot])

    def capacity(self, slot: int) -> int:
        return len(self._pages[slot]) * self.page_size

    # -- logical -> physical -------------------------------------------
    def physical(self, slot: int, pos: int):
        """Map a logical token position to its (page, offset)."""
        if not self._active[slot] or pos >= self._lens[slot]:
            raise IndexError(f"slot {slot} pos {pos} not materialised")
        return self._pages[slot][pos // self.page_size], pos % self.page_size

    def device_table(self) -> np.ndarray:
        """int32 page-table snapshot for scalar prefetch (copy: the
        manager keeps mutating while the device step is in flight)."""
        return self.table.copy()

    def device_row(self, slot: int) -> np.ndarray:
        """One slot's (1, max_pages_per_seq) table snapshot -- what a
        single-sequence prefill chunk needs (avoids copying the whole
        table per chunk)."""
        return self.table[slot:slot + 1].copy()

    # -- reference counting (prefix sharing) ----------------------------
    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def incref(self, page: int) -> None:
        """Add a reference to a resident page (a page with no references
        may be reallocated at any moment, so incref'ing it is a bug)."""
        if page == self.SCRATCH:
            raise ValueError("scratch page cannot be referenced")
        if self._ref[page] <= 0:
            raise ValueError(f"page {page} is free, cannot incref")
        self._ref[page] += 1

    def decref(self, page: int) -> bool:
        """Drop a reference; returns True when the page's last reference
        fell and it went back to the free list."""
        if page == self.SCRATCH:
            raise ValueError("scratch page cannot be referenced")
        if self._ref[page] <= 0:
            raise ValueError(f"page {page} already free, cannot decref")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)
            return True
        return False

    def _take_free(self) -> int:
        page = self._free.pop()
        self._ref[page] = 1
        return page

    def share_pages(self, slot: int, pages: list, n_tokens: int) -> None:
        """Point an empty active slot at already-resident ``pages``
        (incref'ing each): the slot now reads ``n_tokens`` of KV it never
        computed.  ``n_tokens`` may stop short of the last page's
        capacity -- copy-on-write in ``append`` protects the shared tail
        from the slot's own writes."""
        if not self._active[slot]:
            raise ValueError(f"slot {slot} not active")
        if self._pages[slot] or self._lens[slot]:
            raise ValueError(f"slot {slot} not empty")
        if not pages:
            raise ValueError("nothing to share")
        if len(pages) > self.max_pages_per_seq:
            raise ValueError(f"{len(pages)} pages exceeds max_pages_per_seq")
        if not ((len(pages) - 1) * self.page_size
                < n_tokens <= len(pages) * self.page_size):
            raise ValueError(
                f"n_tokens {n_tokens} inconsistent with {len(pages)} pages")
        for page in pages:
            self.incref(page)            # validates resident + not scratch
        for i, page in enumerate(pages):
            self.table[slot, i] = page
        self._pages[slot] = list(pages)
        self._lens[slot] = n_tokens

    # -- alloc / append / free -----------------------------------------
    def alloc(self, slot: int) -> None:
        """Activate an empty slot (no pages yet -- append() materialises
        them lazily as tokens arrive)."""
        if self._active[slot]:
            raise ValueError(f"slot {slot} already active")
        self._active[slot] = True
        self._lens[slot] = 0

    def append(self, slot: int, n: int = 1) -> list:
        """Record ``n`` new tokens for ``slot``, allocating pages as the
        sequence crosses page boundaries.  Returns the newly materialised
        pages (empty when the tokens fit in the current tail page).

        Copy-on-write: when the write would extend a partially-filled
        tail page that other references share, the slot is moved onto a
        fresh page first (old tail decref'd, (src, dst) recorded in
        ``cow_pending`` for the engine to replay on the device pools) --
        a shared page is never written through."""
        if not self._active[slot]:
            raise ValueError(f"slot {slot} not active")
        cur = int(self._lens[slot])
        new_len = cur + n
        need = pages_needed(cur, new_len, self.page_size)
        cow = (n > 0 and cur % self.page_size != 0 and self._pages[slot]
               and self._ref[self._pages[slot][-1]] > 1)
        if -(-new_len // self.page_size) > self.max_pages_per_seq:
            raise OutOfPages(
                f"slot {slot}: {new_len} tokens exceeds "
                f"max_pages_per_seq={self.max_pages_per_seq}")
        if need + (1 if cow else 0) > len(self._free):
            raise OutOfPages(
                f"slot {slot}: need {need + (1 if cow else 0)} pages, "
                f"{len(self._free)} free")
        if self.injector is not None and (need or cow):
            # fires before any mutation: a faulted append is a no-op
            self.injector.fire("page_alloc")
        if cow:
            old = self._pages[slot][-1]
            new = self._take_free()
            self._pages[slot][-1] = new
            self.table[slot, len(self._pages[slot]) - 1] = new
            self.decref(old)
            self.cow_pending.append((old, new))
            if self._c_cow is not None:
                self._c_cow.inc()
        new_pages = []
        for _ in range(need):
            page = self._take_free()
            self.table[slot, len(self._pages[slot])] = page
            self._pages[slot].append(page)
            new_pages.append(page)
        if (need or cow) and self._c_alloc is not None:
            self._c_alloc.inc(need + (1 if cow else 0))
        self._lens[slot] = new_len
        self.peak_used_pages = max(self.peak_used_pages, self.used_pages)
        return new_pages

    def truncate(self, slot: int, n_tokens: int) -> list:
        """Roll a slot back to ``n_tokens`` (speculative-decode rejection:
        drafted rows past the accept point are discarded).  Whole tail
        pages the shorter sequence no longer covers are decref'd -- a
        page shared with another slot or the prefix index stays resident
        for its other holders -- and their table entries reset to
        scratch.  Pending copy-on-write debts whose destination page
        just went back to the free list are cancelled, exactly like
        ``scheduler.abort`` (a freed page may be reallocated before the
        replay runs).  Returns the dropped pages.  Stale rows left in
        the kept tail page need no device-side cleanup: the paged
        kernels mask by sequence length and the next append overwrites
        them."""
        if not self._active[slot]:
            raise ValueError(f"slot {slot} not active")
        cur = int(self._lens[slot])
        if not 0 <= n_tokens <= cur:
            raise ValueError(
                f"slot {slot}: truncate to {n_tokens} outside [0, {cur}]")
        keep = -(-n_tokens // self.page_size)
        dropped = self._pages[slot][keep:]
        freed = set()
        for page in reversed(dropped):
            if self.decref(page):
                freed.add(page)
        del self._pages[slot][keep:]
        self.table[slot, keep:] = self.SCRATCH
        self._lens[slot] = n_tokens
        if freed and self.cow_pending:
            self.cow_pending = [(s, d) for s, d in self.cow_pending
                                if d not in freed]
        return dropped

    def free(self, slot: int) -> None:
        """Retire a slot: drop its reference on every page (pages whose
        last reference falls return to the free list) and reset its
        table row to scratch."""
        if not self._active[slot]:
            raise ValueError(f"slot {slot} not active")
        for page in reversed(self._pages[slot]):
            self.decref(page)
        self._pages[slot] = []
        self.table[slot, :] = self.SCRATCH
        self._lens[slot] = 0
        self._active[slot] = False

    # -- preemption / swap (page-pressure subsystem) --------------------
    def release_pages(self, slot: int) -> list:
        """Preempt a slot: deactivate it and drop its page references
        (exclusive pages return to the free list; shared pages stay
        resident for their other holders).  Returns the page list it
        held so the caller can account for them -- any refcount-1
        contents worth keeping (swap-out) must have been copied off the
        device BEFORE this call, because freed pages may be reallocated
        to another sequence immediately."""
        if not self._active[slot]:
            raise ValueError(f"slot {slot} not active")
        pages = list(self._pages[slot])
        self.free(slot)
        return pages

    def adopt_pages(self, slot: int, n_tokens: int) -> list:
        """Swap-in: activate an empty slot and materialise pages for
        ``n_tokens`` in one shot.  Returns the new page list so the
        caller can scatter host-stashed KV back into them.  On
        OutOfPages the slot is left inactive (clean failure)."""
        self.alloc(slot)
        try:
            self.append(slot, n_tokens)
        except OutOfPages:
            self.free(slot)
            raise
        return list(self._pages[slot])

    @property
    def usable_pages(self) -> int:
        """Pages available to sequences (everything but scratch)."""
        return self.num_pages - 1

    @property
    def peak_utilization(self) -> float:
        """High-water mark as a fraction of the usable pool -- the number
        the over-subscription bench reports (worst-case-reservation
        admission keeps this well below 1; optimistic admission with
        preemption should push it to ~1)."""
        return self.peak_used_pages / max(1, self.usable_pages)

    def reset_peak(self) -> None:
        """Re-arm the high-water mark at the *current* usage (not zero:
        pages already resident -- live sequences, cached prefixes -- are
        part of any peak observed from here on).  Called by
        ``EngineCore.reset_metrics_window()`` so bench warmups do not
        pollute the timed region's peak."""
        self.peak_used_pages = self.used_pages

    # -- invariants (exercised by the property tests) -------------------
    def check_invariants(self, extern_refs: dict = None) -> None:
        """``extern_refs``: page -> count of references held outside any
        slot (the prefix index's holds).  When given, every page's
        refcount must be exactly its slot references plus its external
        references; without it, only ``refcount >= slot references`` can
        be (and is) asserted."""
        slot_refs = np.zeros((self.num_pages,), np.int64)
        for pages in self._pages:
            assert len(pages) == len(set(pages)), \
                "page listed twice by one slot"
            for p in pages:
                slot_refs[p] += 1
        assert slot_refs[self.SCRATCH] == 0, "scratch page was allocated"
        assert self._ref[self.SCRATCH] == 0, "scratch page refcounted"
        free_set = set(self._free)
        assert len(free_set) == len(self._free), "free list duplicate"
        assert self.SCRATCH not in free_set, "scratch page freed"
        for p in range(1, self.num_pages):
            if p in free_set:
                assert self._ref[p] == 0, f"page {p} free with refs"
                assert slot_refs[p] == 0, f"page {p} owned AND free"
            else:
                assert self._ref[p] > 0, f"page {p} leaked (no refs)"
                assert self._ref[p] >= slot_refs[p], \
                    f"page {p} refcount below its slot references"
                if extern_refs is not None:
                    assert self._ref[p] == slot_refs[p] + \
                        extern_refs.get(p, 0), \
                        f"page {p} refcount does not balance"
        if extern_refs is not None:
            for p, n in extern_refs.items():
                assert n > 0 and self._ref[p] >= n, \
                    f"external hold on page {p} unbacked"
        for slot in range(self.max_slots):
            have = len(self._pages[slot])
            assert have * self.page_size >= self._lens[slot], \
                f"slot {slot} under-allocated"
            assert (have - 1) * self.page_size < max(self._lens[slot], 1), \
                f"slot {slot} over-allocated"
            assert list(self.table[slot, :have]) == self._pages[slot], \
                f"slot {slot} table/page-list mismatch"
