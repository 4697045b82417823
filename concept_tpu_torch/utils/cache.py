"""On-disk reusable cache, mirroring the reference's ``.reusable/`` store
(port of concept_tpu/utils/cache.py; reference src/commons.py:5593
``get_reusable_filename``, used for Ewald tables).

Cache root resolution order:
  1. ``CONCEPT_TPU_CACHE`` environment variable
  2. ``.reusable/`` in the current working directory

The keys are the JAX package's, so both packages find the same files.
"""

from __future__ import annotations

import hashlib
import os


def cache_dir(kind: str) -> str:
    root = os.environ.get("CONCEPT_TPU_CACHE", os.path.join(os.getcwd(), ".reusable"))
    path = os.path.join(root, kind)
    os.makedirs(path, exist_ok=True)
    return path


def cache_key(*parts) -> str:
    """Deterministic hash key from the given (stringified) parts."""
    h = hashlib.sha256()
    for p in parts:
        h.update(repr(p).encode())
        h.update(b"\x00")
    return h.hexdigest()[:16]


def cache_filename(kind: str, *parts, ext: str = "npz") -> str:
    return os.path.join(cache_dir(kind), cache_key(*parts) + "." + ext)
