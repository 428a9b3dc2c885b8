"""The port's disk caches: npz files in the JAX package's layout, so that
each package loads the other's. A file lands whole or not at all (written
beside its place and renamed into it); one that cannot be read counts as
missing, as in the JAX package's table loaders."""
from __future__ import annotations

import os
import tempfile
import zipfile

import numpy as np


def cache_root() -> str:
    """$PLONK_TPU_CACHE, default ~/.cache/plonk_tpu (the JAX package's)."""
    return os.environ.get("PLONK_TPU_CACHE",
                          os.path.expanduser("~/.cache/plonk_tpu"))


def load_npz(path: str, names) -> dict | None:
    """The arrays `names` of the npz file at `path`, or None when there is
    no such file or it cannot be read."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            return {k: z[k] for k in names}
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None


def save_npz(path: str, **arrays) -> None:
    """np.savez of `arrays` at `path`, best effort: a write that fails
    leaves no file."""
    tmp = None
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   suffix=".npz.tmp")
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except OSError:
        if tmp is not None and os.path.exists(tmp):
            os.remove(tmp)
