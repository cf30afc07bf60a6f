"""Image pyramid construction — port of `android_svo_tpu/ops/pyramid.py`.

`build_pyramid` gives the per-level tuple; `stack_from_pyramid` packs it
into one zero-padded `(L, Hp, Wp)` stack with level l in the top-left
`(H>>l, W>>l)` corner.  `stack_shape` is unchanged from the JAX package
(rows to a multiple of 8, at least 32; columns to a multiple of 128, at
least 256): the padding decides where the plain versions' border clamps
bind, so the kernels and their plain versions see the same planes.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

MIN_STACK_H = 32
MIN_STACK_W = 256


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def stack_shape(h: int, w: int, n_levels: int) -> tuple[int, int, int]:
    return (n_levels, max(_round_up(h, 8), MIN_STACK_H),
            max(_round_up(w, 128), MIN_STACK_W))


def half_sample(img: torch.Tensor) -> torch.Tensor:
    """2x2 block mean; odd trailing row/col dropped."""
    h, w = img.shape[-2], img.shape[-1]
    h2, w2 = h // 2, w // 2
    x = img[..., : 2 * h2, : 2 * w2]
    x = x.reshape(x.shape[:-2] + (h2, 2, w2, 2))
    return x.mean(dim=(-3, -1))


def build_pyramid(img: torch.Tensor, n_levels: int) -> tuple:
    levels = [img]
    for _ in range(n_levels - 1):
        levels.append(half_sample(levels[-1]))
    return tuple(levels)


def stack_from_pyramid(pyr: Sequence[torch.Tensor]) -> torch.Tensor:
    h, w = pyr[0].shape
    _, hp, wp = stack_shape(h, w, len(pyr))
    planes = [F.pad(im, (0, wp - im.shape[1], 0, hp - im.shape[0]))
              for im in pyr]
    return torch.stack(planes, dim=0)


def build_stack(img: torch.Tensor, n_levels: int) -> torch.Tensor:
    return stack_from_pyramid(build_pyramid(img, n_levels))



def level_view(stack: torch.Tensor, level: int, h: int,
               w: int) -> torch.Tensor:
    """The true (h>>l, w>>l) image of a static level inside a padded stack
    (a view); `h`, `w` are the true level-0 dims."""
    return stack[..., level, : h >> level, : w >> level]


def stack_levels(stack: torch.Tensor, h: int, w: int,
                 n_levels: int | None = None) -> tuple:
    """Unpack a padded stack into the per-level tuple of views."""
    n = n_levels if n_levels is not None else stack.shape[-3]
    return tuple(level_view(stack, l, h, w) for l in range(n))


def pyramid_shapes(h: int, w: int, n_levels: int) -> list:
    shapes = [(h, w)]
    for _ in range(n_levels - 1):
        h, w = h // 2, w // 2
        shapes.append((h, w))
    return shapes
