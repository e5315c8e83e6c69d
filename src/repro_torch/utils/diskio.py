"""Durable atomic file writes.

The serving journal's persistent files (chunk-boundary checkpoints,
the clean-shutdown marker, the service-time estimator) use the same
idiom: write to a sibling ``*.tmp``, then ``os.replace`` onto the
final name, so readers never observe a half-written file.  The rename
alone, however, is only atomic with respect to *other processes* — on a
power loss or kernel crash the data blocks of the tmp file may not have
reached disk yet, and the rename can land while the contents have not,
leaving a **truncated file under the final name** for the
warn-and-regenerate readers to chew on.  These helpers close that hole:

  1. write the payload to ``path + ".tmp"``,
  2. ``flush`` + ``os.fsync`` the tmp file (data durable),
  3. ``os.replace`` onto ``path`` (atomic visibility),
  4. ``fsync`` the containing directory (the rename itself durable).

``fsync=False`` skips steps 2 and 4 for callers that only need the
process-crash atomicity (same behavior as the old idiom).
"""

from __future__ import annotations

import os

__all__ = ["atomic_write_bytes", "atomic_write_text", "fsync_dir"]


def fsync_dir(dirname: str) -> None:
    """fsync a directory so a just-renamed entry survives a power loss.
    Best-effort: some platforms/filesystems refuse O_RDONLY directory
    fds — a failure there degrades to the old (rename-only) guarantee
    instead of breaking the write."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes, *, fsync: bool = True) -> None:
    """Durably write ``data`` to ``path`` via tmp + fsync + replace."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        fsync_dir(os.path.dirname(path))


def atomic_write_text(path: str, text: str, *, fsync: bool = True,
                      encoding: str = "utf-8") -> None:
    atomic_write_bytes(path, text.encode(encoding), fsync=fsync)
