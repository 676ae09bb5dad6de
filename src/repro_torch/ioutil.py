"""Atomic small-file writes shared across subsystems — the torch
port's own copy of ``repro.ioutil`` (standard library only).

Every JSON artifact the port persists — engine metrics snapshots, the
planner's autotune plan cache — is a file another process (or a
restarted engine) will read back and trust.  A plain
``open(path, "w")`` interrupted by ctrl-C or a crash leaves a
half-written file that *parses as corruption* later;
the fix is the classic tmp-file + ``os.replace`` dance (write the full
payload to a temp file in the same directory, fsync, then atomically
rename over the target), which POSIX guarantees readers see either the
old or the new content, never a torn write.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any


def atomic_write_text(path: str, text: str) -> None:
    """Write ``text`` to ``path`` atomically (tmp file + rename)."""
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp.",
                               suffix="." + os.path.basename(path))
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, payload: Any, **json_kwargs: Any) -> None:
    """``json.dump`` with the atomic tmp+rename write.  Serialization
    errors surface *before* the target file is touched — a half
    JSON-able payload can never clobber a good file with garbage."""
    atomic_write_text(path, json.dumps(payload, **json_kwargs))
