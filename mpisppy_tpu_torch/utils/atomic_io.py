###############################################################################
# Atomic text/bytes file writes (port of mpisppy_tpu/utils/atomic_io.py):
# the helper the telemetry metrics snapshot and the flight recorder
# share.  Write-to-tmp + os.replace: a reader (or a scraper tailing the
# metrics file) can never observe a torn half-written file, and a crash
# mid-write leaves the previous complete version in place.
###############################################################################
from __future__ import annotations

import os


def atomic_write_bytes(path: str, payload: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)


def atomic_write_text(path: str, text: str) -> None:
    atomic_write_bytes(path, text.encode())


def fsync_dir(path: str) -> None:
    """fsync the DIRECTORY holding `path` (or the directory itself).

    os.replace makes a rename atomic but not durable: until the
    directory inode is flushed, a crash can roll the directory entry
    back to the pre-rename state — for the checkpoint spool that means
    losing the newest-snapshot pointer even though its bytes fully
    landed.  Callers invoke this after the rename(s) that must survive
    a host loss (cylinders/hub._write_checkpoint rotation).  Platforms
    whose directory handles refuse fsync (some network filesystems,
    Windows) degrade to the old non-durable behavior rather than
    failing the write."""
    d = path if os.path.isdir(path) else (os.path.dirname(path) or ".")
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def append_text(path: str, text: str) -> None:
    """Append one block in a single os.write on an O_APPEND descriptor:
    concurrent appenders never interleave mid-block, and a crash can
    tear at most the final block's tail — the file stays parseable up
    to it.  The incremental companion to atomic_write_text for growing
    artifacts (CSV row batches) where full rewrites would cost
    O(rows^2) I/O over a run."""
    fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
    try:
        os.write(fd, text.encode())
    finally:
        os.close(fd)
