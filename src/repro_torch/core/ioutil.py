"""Atomic file writes.  A copy of `repro.core.ioutil`, kept here because
this package never imports the JAX one.

A crash at any instant leaves either the old file or the new one, never
a torn hybrid: write to a temp file in the same directory (``os.replace``
must not cross filesystems), ``fsync`` the payload, then rename it over
the target in one step.  `kernels.autotune.TuneCache` writes through it.
"""

from __future__ import annotations

import json
import os
import pathlib
import tempfile


def atomic_write_bytes(path, data: bytes) -> None:
    """Write ``data`` to ``path`` such that a crash at any instant leaves
    either the old contents or the new, never a torn file."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent,
                               prefix=path.name + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path, obj, *, indent: int = 1,
                      sort_keys: bool = True) -> None:
    """`json.dumps` through :func:`atomic_write_bytes`."""
    atomic_write_bytes(path, (json.dumps(obj, indent=indent,
                                         sort_keys=sort_keys) + "\n")
                       .encode())
