"""Serving-level KV bookkeeping of the port (``repro.serve.kvcache``): the
analytic page-pool budget and the host-side free-list page allocator the
serving engine schedules against."""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.base import (
    ATTN_GLOBAL,
    ATTN_LOCAL,
    BLOCK_SHARED_ATTN,
    ModelConfig,
)


def paged_cache_bytes(cfg: ModelConfig, num_pages: int, page_size: int,
                      bytes_per_el: int = 2) -> int:
    """Total bytes of the physical page pools across all attention layers
    (matches ``transformer.init_paged_caches``; page tables and lengths
    excluded)."""
    n_attn = sum(1 for kind in cfg.block_pattern
                 if kind in (ATTN_GLOBAL, ATTN_LOCAL, BLOCK_SHARED_ATTN))
    return (n_attn * cfg.pattern_repeats * 2 * num_pages * page_size
            * cfg.kv_dim * bytes_per_el)


class PagedKVCache:
    """Free-list allocator over a pool of ``num_pages`` KV pages.

    The HOST side of the paged cache: it hands out physical page ids and
    tracks per-request page lists; the device side (one pool per attention
    layer) is ``models.layers.PagedKVState``, whose page tables the serving
    engine refreshes from this bookkeeping every step.

    Page 0 is reserved as the NULL page: idle batch slots point their whole
    page-table row at it, so their never-attended decode writes land
    somewhere harmless.  Eviction is cooperative — the engine picks a victim
    and calls :meth:`free` (restart-on-preempt: no copy-out).
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (1 reserved), got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free = deque(range(1, num_pages))      # page 0 = null page
        self._owned: Dict[int, List[int]] = {}       # rid -> page ids

    @property
    def n_free(self) -> int:
        return len(self._free)

    def n_owned(self, rid: int) -> int:
        return len(self._owned.get(rid, ()))

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` positions."""
        return -(-tokens // self.page_size)

    def alloc(self, rid: int, n: int) -> Optional[List[int]]:
        """Grab ``n`` fresh pages for ``rid``; None (nothing allocated) when
        the free list can't cover it."""
        if n > len(self._free):
            return None
        got = [self._free.popleft() for _ in range(n)]
        self._owned.setdefault(rid, []).extend(got)
        return got

    def ensure(self, rid: int, n_total: int) -> bool:
        """Grow ``rid``'s allocation to ``n_total`` pages (no-op when it
        already owns enough).  False (and no change) when the pool is dry."""
        need = n_total - self.n_owned(rid)
        if need <= 0:
            return True
        return self.alloc(rid, need) is not None

    def free(self, rid: int) -> int:
        """Return all of ``rid``'s pages to the free list."""
        pages = self._owned.pop(rid, [])
        self._free.extend(pages)
        return len(pages)

    def page_row(self, rid: int, width: int) -> np.ndarray:
        """``rid``'s page-table row, padded to ``width`` with the null
        page."""
        pages = self._owned.get(rid, [])
        row = np.zeros((width,), np.int32)
        row[:len(pages)] = pages[:width]
        return row
