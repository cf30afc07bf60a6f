"""Persistent kernel cache — the port's counterpart of
`android_svo_tpu/utils/cache.py` (the persistent XLA compilation cache).

The port compiles its CUDA kernels, not a traced program: `ops/cuda_build.py`
builds one library whose file name carries a digest of every source and
flag, so a library built once is reused by every later process that points
its build directory at the same place.  `enable_compilation_cache` does
that pointing; building stays lazy (the first CUDA launch, or
`cuda_build.build()`).
"""

from __future__ import annotations

import os
from pathlib import Path

from android_svo_tpu_torch.ops import cuda_build

DEFAULT_CACHE_DIR = str(cuda_build.BUILD_DIR)


def enable_compilation_cache(path: str | None = None) -> None:
    """Build and look up the kernel library in `path` (default
    `DEFAULT_CACHE_DIR`, `build/torch_kernels/` at the repository root)."""
    path = path or DEFAULT_CACHE_DIR
    os.makedirs(path, exist_ok=True)
    cuda_build.BUILD_DIR = Path(path)
