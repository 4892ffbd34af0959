"""Atomic artifact writes: tmp-then-rename, fsync'd, as the JAX package's
``utils/atomicio.py``.

Any file a restore or a consumer SCANS (a checkpoint manifest above all)
must never be observable half-written.  The protocol:

1. write the whole payload to ``<path>.tmp-<pid>`` in the SAME directory
   (``os.replace`` is only atomic within one filesystem);
2. flush and ``os.fsync`` the file, so the bytes are durable before the
   name is;
3. ``os.replace`` onto the final name (atomic on POSIX);
4. optionally fsync the parent directory so that the rename survives a
   power cut (``fsync_dir``; the checkpoint writer does).

stdlib only.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Iterator


def _tmp_path(path: str) -> str:
    head, tail = os.path.split(path)
    return os.path.join(head, f".{tail}.tmp-{os.getpid()}")


def atomic_write_bytes(path: str, data: bytes, fsync: bool = True) -> None:
    """Write ``data`` to ``path`` atomically (tmp + fsync + rename)."""
    tmp = _tmp_path(path)
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        # Never leave a stray tmp behind a failed write.
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_text(path: str, text: str, fsync: bool = True) -> None:
    atomic_write_bytes(path, text.encode("utf-8"), fsync=fsync)


def atomic_write_json(path: str, obj: Any, fsync: bool = True, **json_kwargs: Any) -> None:
    """``json.dump`` with the atomic protocol (the manifest idiom)."""
    atomic_write_text(path, json.dumps(obj, **json_kwargs), fsync=fsync)


@contextlib.contextmanager
def atomic_writer(path: str, mode: str = "w", fsync: bool = True) -> Iterator[Any]:
    """Streaming atomic write: yields the tmp file object, commits by rename
    on a clean exit, unlinks on error."""
    tmp = _tmp_path(path)
    try:
        with open(tmp, mode) as f:
            yield f
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so that a completed rename inside it is durable.
    Best-effort: where the filesystem refuses a directory fsync the rename
    is still atomic, only its durability window widens."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
