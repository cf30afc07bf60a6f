"""Deterministic scatter/compaction helpers standing in for JAX's
`.at[idx].set(..., mode="drop")`, `.at[idx].add(...)` and
`jnp.nonzero(size=, fill_value=-1)`.

torch raises on the CPU and asserts on the device for out-of-range indices,
so every out-of-range (sentinel) index is redirected to one padding row that
is sliced off afterwards.  Callers keep real indices unique: a duplicate
write has no defined order on the device.  Every write is out of place, so
the helpers run under `torch.func.vmap` also where the written tensor is
made inside the function and the indices carry the batch.
"""

from __future__ import annotations

import torch


def _redirect(idx: torch.Tensor, n: int) -> torch.Tensor:
    idx = idx.to(torch.int64)
    return torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))


def set_rows(dst: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """dst.at[idx].set(val, mode="drop") along dim 0 (a new tensor)."""
    n = dst.shape[0]
    out = torch.cat([dst, dst[:1]], dim=0)
    val = torch.as_tensor(val, dtype=dst.dtype, device=dst.device)
    return out.index_put((_redirect(idx, n),), val)[:n]


def add_rows(dst: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """dst.at[idx].add(val, mode="drop") along dim 0."""
    n = dst.shape[0]
    out = torch.cat([dst, torch.zeros_like(dst[:1])], dim=0)
    ridx = _redirect(idx, n)
    if not torch.is_tensor(val):
        val = torch.full(ridx.shape + dst.shape[1:], val, dtype=dst.dtype,
                         device=dst.device)
    return out.index_add(0, ridx, val.to(dst.dtype))[:n]


def compact(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Indices of the first `size` True entries of a 1-D mask, in order,
    padded with -1 (jnp.nonzero(mask, size=size, fill_value=-1)[0])."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    keep = mask & (pos < size)
    dst = torch.where(keep, pos, torch.full_like(pos, size))
    out = torch.full((size + 1,), -1, dtype=torch.int64, device=mask.device)
    return out.scatter(0, dst, torch.arange(n, device=mask.device))[:size]


def take_row(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src[idx] for a 0-d index tensor, read on the device: indexing with a
    0-d tensor reads the index back to the host (`aten::item`, a blocking
    copy from the card); a one-row `index_select` does not."""
    return src.index_select(0, idx.reshape(1).to(torch.int64))[0]


def put_row(dst: torch.Tensor, idx: torch.Tensor, row) -> torch.Tensor:
    """dst with row idx (a 0-d index tensor) set to `row` (broadcast), as
    a new tensor, without reading the index back to the host."""
    row = torch.as_tensor(row, dtype=dst.dtype, device=dst.device)
    return dst.index_put((idx.reshape(1).to(torch.int64),), row)


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src[idx] with -1 (and any out-of-range index) clamped into range —
    the rows it reads for sentinel indices are masked by the caller."""
    return src[idx.to(torch.int64).clamp(0, src.shape[0] - 1)]
