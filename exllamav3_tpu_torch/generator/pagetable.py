"""Paged KV bookkeeping: content-hash prefix reuse, ref counting, eviction
(counterpart of exllamav3_tpu/generator/pagetable.py; the CPU second tier
and defragmentation wait).

Page index 0 is reserved as the scratch target: padded rows and unused block
table columns point there, so every write goes through a valid index.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from ..constants import PAGE_SIZE


def _page_hash(prev_hash: bytes | None, ids: np.ndarray) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(prev_hash or b"\x00" * 16)
    h.update(np.ascontiguousarray(ids, dtype=np.int64).tobytes())
    return h.digest()


@dataclass
class CachePage:
    index: int
    ref_count: int = 0
    page_hash: bytes | None = None  # set when the page is complete
    prev_hash: bytes | None = None
    access_serial: int = 0


class PageTable:
    def __init__(self, num_pages: int):
        assert num_pages >= 2
        self.num_pages = num_pages
        self.page_size = PAGE_SIZE
        self.pages = [CachePage(index=i) for i in range(num_pages)]
        self.pages[0].ref_count = 1  # scratch page
        self.hash_index: dict[bytes, int] = {}
        self.access_serial = 0
        self.cached_pages_served = 0
        self.cached_tokens_served = 0

    def _touch(self, page: CachePage):
        self.access_serial += 1
        page.access_serial = self.access_serial

    def _evict_one(self) -> CachePage | None:
        """Free the least recently used unreferenced page."""
        cand = None
        for p in self.pages[1:]:
            if p.ref_count == 0 and (cand is None or p.access_serial < cand.access_serial):
                cand = p
        if cand is None:
            return None
        if cand.page_hash is not None and self.hash_index.get(cand.page_hash) == cand.index:
            del self.hash_index[cand.page_hash]
        cand.page_hash = None
        cand.prev_hash = None
        return cand

    def allocate_sequence(self, ids: np.ndarray) -> tuple[list[int], int] | None:
        """Pages for a prompt, reusing complete cached pages by hash-chain
        prefix match. Returns (page indices, reused tokens) or None when out
        of pages."""
        n = len(ids)
        allocated: list[int] = []
        reused_tokens = 0
        prev_hash: bytes | None = None
        matching = True
        for pi in range((n + self.page_size - 1) // self.page_size):
            a, b = pi * self.page_size, min((pi + 1) * self.page_size, n)
            page_hash = _page_hash(prev_hash, ids[a:b]) if b - a == self.page_size else None
            idx = self.hash_index.get(page_hash) if matching and page_hash is not None else None
            if idx is not None:
                hit = self.pages[idx]
                hit.ref_count += 1
                self._touch(hit)
                allocated.append(hit.index)
                reused_tokens += self.page_size
                self.cached_pages_served += 1
                self.cached_tokens_served += self.page_size
            else:
                page = self._evict_one()
                if page is None:
                    for i in allocated:  # roll back
                        self.pages[i].ref_count -= 1
                    return None
                page.ref_count = 1
                page.prev_hash = prev_hash
                # the hash registers only once prefill fills the page
                page.page_hash = None
                self._touch(page)
                allocated.append(page.index)
                matching = False
            prev_hash = page_hash
        return allocated, reused_tokens

    def extend_sequence(self) -> int | None:
        """One more page for decode growth."""
        page = self._evict_one()
        if page is None:
            return None
        page.ref_count = 1
        self._touch(page)
        return page.index

    def finalize_page(self, page_idx: int, prev_hash: bytes | None, ids: np.ndarray):
        """Register a just-completed page for prefix reuse."""
        page = self.pages[page_idx]
        if page.ref_count <= 0:
            return
        h = _page_hash(prev_hash, ids)
        page.prev_hash = prev_hash
        page.page_hash = h
        self.hash_index[h] = page_idx  # latest writer wins

    def release_sequence(self, page_indices: list[int]):
        for i in page_indices:
            p = self.pages[i]
            p.ref_count = max(0, p.ref_count - 1)
            self._touch(p)
