"""Sums whose rounding does not depend on a batch.

`torch.func.vmap` runs an op once on the whole batch, and on CUDA a
reduction over many elements (`torch.sum` over a large axis, an einsum
that becomes a matrix product) picks its parallel split from the batched
shape, so an element of the batched tracking step would round its normal
equations differently from the same sequence's single step, and
Gauss-Newton's accept/stop tests would now and then flip.  `fixed_sum`
sums in a fixed tree instead: contiguous rows of at most 64 terms, level by
level, each row summed by itself whatever the number of rows, which is the
same computation with and without the batch on the CPU and on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

CHUNK = 64


def fixed_sum(x: torch.Tensor, n_dims: int) -> torch.Tensor:
    """Sum of x over its first `n_dims` dimensions, as rows of CHUNK terms
    summed level by level (the terms zero-padded to a whole number of
    rows)."""
    rest = x.shape[n_dims:]
    m = math.prod(x.shape[:n_dims])
    levels = 1
    while CHUNK ** levels < m:
        levels += 1
    block = CHUNK ** (levels - 1)
    y = x.reshape(m, -1).transpose(0, 1)          # (terms of each output)
    y = F.pad(y, (0, (-m) % block))
    y = y.reshape((y.shape[0], -1) + (CHUNK,) * (levels - 1))
    for _ in range(levels):
        y = y.sum(-1)
    return y.reshape(rest)
