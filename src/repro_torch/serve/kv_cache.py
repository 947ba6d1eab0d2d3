"""DEX-paged KV cache: the paper's index as the serving page table.

The KV pool is a flat page pool on the card whose ownership map,
``(request, page index) -> page``, is a DEX B+-tree (``core/btree.py``), also
on the card.  The host control plane admits requests and grows them by
index inserts and frees them by a range delete; the data plane resolves the
page tables of a batch with one batched lookup per step and attends with the
``paged_attention`` kernel (``serve/serve_step.py``).

The port of ``repro.serve.kv_cache``.  The pools are written in place
(``append_tokens``), where the reference rebuilds them functionally.  Every
index operation returns a new tree, and a rebuild on a split replaces all
of its arrays, so the cache holds the tree only as ``self.tree`` and never
a view into one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import btree
from repro_torch.core.mesh import resolve_device
from repro_torch.core.nodes import KEY_MAX
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import torch_dtype

#: key layout: (request id << PAGE_BITS) | page index
PAGE_BITS = 24


def page_key(req_id, page_idx):
    return (np.int64(req_id) << PAGE_BITS) | np.int64(page_idx)


def _keys(req_ids, page_idx) -> np.ndarray:
    return (np.asarray(req_ids, np.int64) << PAGE_BITS) | np.asarray(page_idx, np.int64)


@dataclasses.dataclass
class PagedKVCache:
    """Host-controlled paged pool with a DEX page-table index; pools and
    index live on ``device`` (``None`` means CUDA).  An MLA config raises
    ``ValueError`` (its cache is the compressed dense one), and so does an
    encoder-decoder one (it decodes through the dense cache with its cross
    planes)."""

    cfg: ArchConfig
    n_pages: int
    page_size: int
    max_batch: int
    device: Optional[torch.device] = None

    def __post_init__(self):
        c = self.cfg
        if c.attention == "mla":
            raise ValueError(
                f"{c.name}: the paged pool holds GQA keys and values; an MLA model"
                " decodes through model.decode_step over its compressed cache"
            )
        if c.encdec:
            raise ValueError(
                f"{c.name}: the paged pool has no cross-attention planes; an"
                " encoder-decoder model decodes through model.decode_step"
            )
        self.device = resolve_device(self.device)
        shape = (c.n_layers, self.n_pages, self.page_size, c.n_kv_heads, c.head_dim)
        self.k_pages = torch.zeros(shape, dtype=torch_dtype(c), device=self.device)
        self.v_pages = torch.zeros_like(self.k_pages)
        self.free: List[int] = list(range(self.n_pages))[::-1]
        self.seq_lens: Dict[int, int] = {}
        self.allocated: Dict[int, int] = {}
        # the page-table index, bootstrapped with a sentinel key
        keys = np.array([KEY_MAX - 1], dtype=np.int64)
        self.tree, self.meta = btree.bulk_build(
            keys, np.zeros(1, np.int64), device=self.device
        )
        self.lookups = 0

    # -- control plane (host): allocation via index inserts -------------------

    def pages_per_req(self, seq_len: int) -> int:
        return -(-seq_len // self.page_size)

    def _insert(self, keys: np.ndarray, pages: List[int]) -> None:
        self.tree, self.meta, ok = btree.batch_insert(
            self.tree, self.meta, keys, np.array(pages, np.int64)
        )
        assert bool(np.all(ok))

    def admit_request(self, req_id: int, prompt_len: int) -> List[int]:
        n = self.pages_per_req(max(prompt_len, 1))
        if len(self.free) < n:
            raise MemoryError("page pool exhausted")
        pages = [self.free.pop() for _ in range(n)]
        self._insert(_keys(req_id, np.arange(n)), pages)
        self.seq_lens[req_id] = prompt_len
        self.allocated[req_id] = n
        return pages

    def extend_request(self, req_id: int) -> Optional[int]:
        """Grow the request by one token; allocates (and index-inserts) a new
        page iff the new length spills past the allocated pages."""
        cur = self.seq_lens[req_id]
        self.seq_lens[req_id] = cur + 1
        needed = self.pages_per_req(cur + 1)
        if needed <= self.allocated[req_id]:
            return None
        if not self.free:
            raise MemoryError("page pool exhausted")
        page = self.free.pop()
        self._insert(_keys([req_id], [needed - 1]), [page])
        self.allocated[req_id] = needed
        return page

    def release_request(self, req_id: int) -> int:
        """Range-delete the request's keys; returns pages reclaimed."""
        self.seq_lens.pop(req_id)
        n = self.allocated.pop(req_id)
        keys = _keys(req_id, np.arange(n))
        found, vals = btree.bulk_lookup(self.tree, keys, height=self.meta.height)
        pages = vals.cpu().numpy()[found.cpu().numpy()]
        self.tree, _ = btree.bulk_delete(self.tree, keys, height=self.meta.height)
        self.free.extend(int(p) for p in pages)
        return len(pages)

    # -- data plane (device): batched page-table resolution -------------------

    def resolve_tables(self, req_ids: np.ndarray, pages_per_req: int) -> torch.Tensor:
        """[B, ppr] int32 page table via one batched DEX lookup; a page not
        allocated reads as page 0 (the length mask keeps it out)."""
        b = len(req_ids)
        keys = _keys(np.asarray(req_ids)[:, None], np.arange(pages_per_req)[None, :])
        found, vals = btree.bulk_lookup(
            self.tree, keys.reshape(-1), height=self.meta.height
        )
        self.lookups += keys.size
        table = torch.where(found, vals, 0).reshape(b, pages_per_req)
        return table.to(torch.int32)

    def batch_seq_lens(self, req_ids: np.ndarray) -> torch.Tensor:
        lens = [self.seq_lens[int(r)] for r in req_ids]
        return torch.tensor(lens, dtype=torch.int32, device=self.device)

    # -- writes (append one token's KV for every layer) ------------------------

    def append_tokens(self, req_ids: np.ndarray, k_new: torch.Tensor, v_new: torch.Tensor):
        """k_new / v_new: [L, B, HKV, Dh] for the token at position
        seq_len - 1 (callers bump seq_lens via extend_request first),
        scattered into the pools in place.  Returns the pages (numpy)."""
        pos = np.array([self.seq_lens[int(r)] - 1 for r in req_ids])
        page_idx = pos // self.page_size
        offset = pos % self.page_size
        found, vals = btree.bulk_lookup(
            self.tree, _keys(req_ids, page_idx), height=self.meta.height
        )
        assert bool(found.all()), "page table hole"
        pages = vals.cpu().numpy().astype(np.int32)
        # advanced-index scatter: [L, B, HKV, Dh] -> (layer, page_b, offset_b)
        idx_p = torch.from_numpy(pages.astype(np.int64)).to(self.device)
        idx_o = torch.from_numpy(offset.astype(np.int64)).to(self.device)
        self.k_pages[:, idx_p, idx_o] = k_new
        self.v_pages[:, idx_p, idx_o] = v_new
        return pages
