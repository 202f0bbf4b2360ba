"""Paged / block KV cache for the continuous-batching scheduler.

The paper's packing discipline applied to the KV stream one level up:
instead of reserving a dense ``max_len`` cache per slot (the batch-1 front
end's layout), K / V live in a global pool of fixed-size BLOCKS and each
slot maps its positions onto blocks through a per-slot block table —
sequence LENGTH is decoupled from ALLOCATION, so a batch of mostly-short
requests no longer pays for the longest request's worst case.

Block-accounting contract
=========================

* The pool holds ``num_blocks + 1`` blocks per layer; **block 0 is the NULL
  block** — it backs every unallocated table entry, absorbs the dead rows'
  writes of the batched step, and is NEVER validly read: any gathered
  position it backs lies beyond the owning slot's current length, which the
  decode attention mask excludes exactly (masked logits are ``-1e30``, so
  their weight is exactly zero and the value product adds exactly zero).
  Block 0 is never allocated and never freed.
* :class:`BlockAllocator` hands out blocks lowest id first (deterministic
  layouts for bitwise replay tests) and detects double frees. **Exhaustion
  is a typed backpressure signal**: :meth:`BlockAllocator.try_alloc`
  returns ``None`` when the pool is short — it never raises for load. The
  armed ``kv_alloc`` fault site (class ``resource``) fires inside
  ``try_alloc`` to stand in for allocator failure.
* **No leaks**: every block allocated to a slot is returned by
  :meth:`PagedKVCache.release` (completion, eviction, deadline miss, or
  preemption), and released blocks are SCRUBBED to zero before reuse — a
  NaN parked in a recycled block would otherwise leak through the masked
  value product (0 · NaN = NaN). After a full drain
  ``alloc.free_count == alloc.capacity``.
* ``max_len % block_size == 0`` is required so that a fully tabled slot
  gathers to EXACTLY the dense ``max_len`` cache that ``prefill`` /
  ``decode`` use.

Layout: the model's caches are a list per layer of ``{"kv": {"k", "v"}}``
with leaves ``[B, max_len, Hkv, D]`` (``models/transformer.py``). The pool
stacks the layers: ``pool[name]: [L, num_blocks + 1, block_size, Hkv, D]``,
so one advanced index ``pool[:, tables]`` gathers every layer of every row
at once, and :meth:`PagedKVCache.gather` hands the model per-layer views of
that copy.

Supported families: decoder-only token LMs with full attention (dense /
moe). Sliding-window rings, SSM state, and encoder-decoder or VLM caches
are not paged here (the ring wrap and non-KV state break the block
mapping); constructing a :class:`PagedKVCache` for one raises
``ValueError``.

Quantized pool (``quantize="int8"``)
====================================

The pool leaves store int8 values plus per-POSITION f32 scale leaves
``scales[name]: [L, num_blocks + 1, block_size]`` — one absmax / 127 scale
per (layer, block, position) over that position's ``[Hkv, D]`` vector.
The contract clauses above hold unchanged, plus:

* **Quantize exactly once per position.** Every write path —
  ``insert_dense``, ``write_position``, and the batched step's
  ``scatter`` (which the scheduler's resume replay runs too) — quantizes a
  position's vector with :func:`quantize_kv_position` at write time and
  never quantizes it again (re-quantizing a dequantized vector is NOT
  idempotent: absmax drifts by the rounding error, which would break the
  bitwise preempt / resume contract). Reads dequantize ``q * scale`` into
  the compute dtype.
* Per-position (not per-block) scales for the same reason: appending a
  position to a block must not touch its neighbours' committed bytes.
* The null block's scales are 1.0 (its zeros dequantize to exactly zero);
  ``release`` scrubs a slot's scale entries back to 1.0 alongside the
  zeroed values.

This module is the port's copy of the JAX package's ``serve/kv_cache.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.dtypes import torch_dtype
from repro_torch.models.model_registry import resolve_device
from repro_torch.testing import faults

# The two paged leaves of a decoder-only attention cache.
_KV_LEAVES = ("k", "v")


def quantize_kv_position(x: torch.Tensor):
    """``x: [..., Hkv, D]`` float -> (int8 values, f32 per-position scales
    ``[...]``). absmax / 127 per position, round half to even, then clip;
    an all-zero position gets scale 1.0 (its zeros stay exactly zero
    through the round trip). The ONE quantization formula every write path
    shares."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=(-2, -1))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Elementwise ``q * scale`` into ``dtype`` (the scale broadcasts over
    the trailing [Hkv, D] axes)."""
    return (q.to(torch.float32) * scale[..., None, None]).to(dtype)


class BlockAllocator:
    """Deterministic fixed-size block allocator (ids ``1..capacity``).

    Lowest-id-first allocation order, double-free detection, and typed
    backpressure: ``try_alloc`` returns ``None`` on real exhaustion (the
    caller preempts or waits — it never crashes), and raises
    :class:`~repro_torch.testing.faults.InjectedFault` only when the
    ``kv_alloc`` fault site is armed for the hit.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"need at least one KV block, got {capacity}")
        self.capacity = int(capacity)
        self._free: List[int] = list(range(1, capacity + 1))  # sorted asc
        self._used: set = set()

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return len(self._used)

    def try_alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` blocks (lowest ids first) or return ``None`` if
        the pool cannot satisfy the request — exhaustion is backpressure,
        not an exception. Fault site ``kv_alloc`` fires here when armed."""
        faults.maybe_fail("kv_alloc")
        if n < 0:
            raise ValueError(f"negative allocation {n}")
        if n > len(self._free):
            return None
        blocks, self._free = self._free[:n], self._free[n:]
        self._used.update(blocks)
        return blocks

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            if b not in self._used:
                raise ValueError(f"double free / foreign block {b}")
            self._used.discard(b)
        self._free = sorted(self._free + list(blocks))


class PagedKVCache:
    """The block-pooled KV store behind the continuous scheduler's rows.

    Device state is two pooled leaves, ``pool[name]: [L, num_blocks + 1,
    block_size, Hkv, D]`` for ``name`` in ``("k", "v")``, plus a HOST block
    table ``tables: [max_live, blocks_per_slot] int32`` mapping each slot's
    position range onto pool blocks (0 = the null block). The batched
    decode step gathers ``pool[:, tables]`` into the dense per-layer view
    the unchanged model ``decode`` consumes (:meth:`gather`), and scatters
    back only the one position each row wrote (:meth:`scatter`).

    ``quantize="int8"`` stores the pool as int8 values + per-position f32
    scale leaves (see the module docstring's quantized-pool contract);
    reads dequantize into ``cache_dtype``, writes quantize exactly once.
    The pool lives on ``device`` (the card by default; raises without one).
    """

    def __init__(self, model_cfg, *, max_live: int, max_len: int,
                 block_size: int, num_blocks: int, cache_dtype="float32",
                 quantize: Optional[str] = None, device=None):
        if model_cfg.is_encoder_decoder or model_cfg.has_ssm \
                or model_cfg.family == "vlm" or not model_cfg.has_attention \
                or model_cfg.attention_type == "sliding_window":
            raise ValueError(
                "paged KV supports decoder-only full-attention token LMs "
                f"({model_cfg.name}: family {model_cfg.family!r}, attention "
                f"{model_cfg.attention_type!r} not pageable)")
        if max_len % block_size != 0:
            raise ValueError(f"max_len={max_len} must be a multiple of "
                             f"block_size={block_size} (gathered view must "
                             "equal the dense batch-1 cache exactly)")
        if quantize not in (None, "int8"):
            raise ValueError(
                f"unsupported KV quantize={quantize!r} (only 'int8')")
        self.device = resolve_device(device)
        self.max_live = int(max_live)
        self.max_len = int(max_len)
        self.block_size = int(block_size)
        self.blocks_per_slot = max_len // block_size
        self.num_layers = model_cfg.num_layers
        self.alloc = BlockAllocator(num_blocks)
        self.quantize = quantize
        self.compute_dtype = torch_dtype(cache_dtype)
        dtype = torch.int8 if quantize else self.compute_dtype
        pool_shape = (model_cfg.num_layers, num_blocks + 1, block_size,
                      model_cfg.num_kv_heads, model_cfg.head_dim)
        self.pool: Dict[str, torch.Tensor] = {
            name: torch.zeros(pool_shape, dtype=dtype, device=self.device)
            for name in _KV_LEAVES}
        # Per-position dequant scales (quantized pools only): 1.0 everywhere
        # at rest — the null block's zeros dequantize to exactly zero.
        self.scales: Optional[Dict[str, torch.Tensor]] = None
        if quantize:
            self.scales = {name: torch.ones(pool_shape[:3], dtype=torch.float32,
                                            device=self.device)
                           for name in _KV_LEAVES}
        # Host side: per-slot block lists (allocation order == position
        # order) and the dense table the batched step consumes.
        self._slot_blocks: List[List[int]] = [[] for _ in range(max_live)]
        self.tables = np.zeros((max_live, self.blocks_per_slot), np.int32)
        self._tables_dev = None  # device mirror, invalidated on table edits

    # ----- accounting -----------------------------------------------------

    def blocks_for(self, length: int) -> int:
        """Blocks needed to back positions ``0 .. length - 1``."""
        return max(0, -(-length // self.block_size))

    def slot_block_count(self, slot: int) -> int:
        return len(self._slot_blocks[slot])

    def accounting_consistent(self) -> bool:
        """Every table entry's block is either null or owned by exactly one
        slot, and used / free counts close against capacity."""
        owned = [b for blocks in self._slot_blocks for b in blocks]
        tabled = sorted(int(b) for b in self.tables.reshape(-1) if b)
        return (len(owned) == len(set(owned))
                and set(owned) == self.alloc._used
                and tabled == sorted(owned)
                and self.alloc.free_count + self.alloc.used_count
                == self.alloc.capacity)

    def pool_bytes(self) -> int:
        """Device bytes resident in the KV pool: value leaves plus, for a
        quantized pool, the per-position scale leaves (the honest total a
        block budget must cover)."""
        leaves = list(self.pool.values())
        if self.scales is not None:
            leaves += list(self.scales.values())
        return sum(t.numel() * t.element_size() for t in leaves)

    def bytes_per_block(self) -> int:
        """Pool bytes per (layer-stacked) block — the per-token KV cost is
        this divided by ``block_size``."""
        return self.pool_bytes() // (self.alloc.capacity + 1)

    # ----- allocation / release -------------------------------------------

    def grow(self, slot: int, length: int) -> bool:
        """Ensure ``slot`` has blocks backing positions ``0 .. length - 1``.
        True on success; False on real pool exhaustion (typed backpressure
        — the caller preempts or waits). Raises ``InjectedFault`` only when
        the ``kv_alloc`` site is armed."""
        have = len(self._slot_blocks[slot])
        need = self.blocks_for(length) - have
        if need <= 0:
            return True
        got = self.alloc.try_alloc(need)
        if got is None:
            return False
        self.tables[slot, have:have + need] = got
        self._slot_blocks[slot].extend(got)
        self._tables_dev = None
        return True

    def release(self, slot: int) -> None:
        """Return the slot's blocks to the pool, scrubbing them to zero
        first (a NaN left in a recycled block would leak through the masked
        value product: 0 · NaN = NaN), and reset its table row to null.
        Quantized pools reset the blocks' scales to 1.0 alongside."""
        blocks = self._slot_blocks[slot]
        if blocks:
            idx = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
            for name in _KV_LEAVES:
                self.pool[name][:, idx] = 0
                if self.quantize:
                    self.scales[name][:, idx] = 1.0
            self.alloc.free(blocks)
        self._slot_blocks[slot] = []
        self.tables[slot, :] = 0
        self._tables_dev = None

    # ----- data movement --------------------------------------------------

    def _row(self, slot: int) -> torch.Tensor:
        return torch.as_tensor(self.tables[slot], dtype=torch.long,
                               device=self.device)

    def _put(self, name: str, index, values: torch.Tensor, flat: bool) -> None:
        """Write ``values`` (float, compute layout) at ``index`` of the
        pool leaf (``flat``: ``index`` counts positions over [blocks *
        block_size], else blocks), quantizing once on a quantized pool."""
        pool = self.pool[name]
        if flat:
            pool = pool.view(pool.shape[0], -1, *pool.shape[3:])
        if not self.quantize:
            pool[:, index] = values.to(pool.dtype)
            return
        q, s = quantize_kv_position(values)
        scales = self.scales[name]
        if flat:
            scales = scales.view(scales.shape[0], -1)
        pool[:, index] = q
        scales[:, index] = s

    def insert_dense(self, slot: int, caches) -> None:
        """Scatter a batch-1 dense cache (the per-layer list of
        ``{"kv": {"k", "v"}}`` with leaves ``[1, max_len, Hkv, D]`` that
        ``Engine.prefill_request`` / ``decode_request`` return) into the
        slot's blocks. Table entries still null receive the dense cache's
        zero padding. A quantized pool quantizes each position here,
        exactly once (zero padding rounds to zero values with scale 1.0)."""
        row = self._row(slot)
        for name in _KV_LEAVES:
            leaf = torch.stack([c["kv"][name][0] for c in caches])
            blocks = leaf.reshape(leaf.shape[0], self.blocks_per_slot,
                                  self.block_size, *leaf.shape[2:])
            self._put(name, row, blocks, flat=False)

    def write_position(self, slot: int, pos: int, caches) -> None:
        """Commit ONE written position from a batch-1 decode's caches into
        the slot's block."""
        block = int(self.tables[slot, pos // self.block_size])
        if block == 0:
            raise ValueError(f"slot {slot} position {pos} not backed by an "
                             "allocated block")
        dest = block * self.block_size + pos % self.block_size
        for name in _KV_LEAVES:
            written = torch.stack([c["kv"][name][0, pos] for c in caches])
            self._put(name, dest, written, flat=True)

    def _view(self, name: str, tables: torch.Tensor) -> torch.Tensor:
        """``pool[:, tables]`` as a dense ``[L, B, max_len, Hkv, D]`` copy in
        the compute dtype (advanced indexing copies; a quantized pool
        dequantizes elementwise)."""
        g = self.pool[name][:, tables]               # [L, B, MB, bs, Hkv, D]
        if self.quantize:
            g = dequantize_kv(g, self.scales[name][:, tables],
                              self.compute_dtype)
        return g.reshape(g.shape[0], tables.shape[0], self.max_len,
                         *g.shape[4:])

    def gather(self, tables: torch.Tensor) -> list:
        """The dense per-layer caches of the rows of ``tables`` ([B, MB]
        long on the pool's device): ``[{"kv": {"k", "v"}}] * L`` with
        leaves ``[B, max_len, Hkv, D]``, views of a COPY of the pool — the
        model's in-place write of the new position lands in the copy, and
        the pool changes only at :meth:`scatter`."""
        views = {name: self._view(name, tables) for name in _KV_LEAVES}
        return [{"kv": {name: views[name][layer] for name in _KV_LEAVES}}
                for layer in range(self.num_layers)]

    def scatter(self, caches, tables: torch.Tensor, pos: torch.Tensor) -> None:
        """Commit the one position each row of a batched decode wrote:
        row b's ``caches[l]["kv"][name][b, pos[b]]`` to its block
        ``tables[b, pos[b] // block_size]`` (dead rows — null tables, pos
        0 — write into the null block, which is never read)."""
        rows = torch.arange(tables.shape[0], device=tables.device)
        dest = (tables[rows, pos // self.block_size] * self.block_size
                + pos % self.block_size)
        for name in _KV_LEAVES:
            written = torch.stack([c["kv"][name][rows, pos] for c in caches])
            self._put(name, dest, written, flat=True)

    def gather_slot(self, slot: int) -> list:
        """The slot's dense batch-1 cache view (the port's per-layer list
        with leaves ``[1, max_len, Hkv, D]``) — the cache the batch-1
        programs would hold; a quantized pool dequantizes into the compute
        dtype, elementwise, as the batched step's gather does."""
        return self.gather(self._row(slot)[None])

    def device_tables(self) -> torch.Tensor:
        """The block table as a long tensor on the pool's device (cached;
        table edits invalidate the mirror)."""
        if self._tables_dev is None:
            self._tables_dev = torch.as_tensor(self.tables, dtype=torch.long,
                                               device=self.device)
        return self._tables_dev
