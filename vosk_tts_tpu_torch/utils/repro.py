"""Reproducibility helpers (vosk_tts_tpu/utils/repro.py; the reference's
utils.py:201-218 check_git_hash)."""

from __future__ import annotations

import logging
import os
import subprocess

log = logging.getLogger("vosk_tts_tpu_torch.repro")


def git_hash() -> str | None:
    """The commit checked out in the working directory, or None outside a
    git checkout (or without git)."""
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                              text=True, timeout=10).stdout.strip() or None
    except Exception:
        return None


def check_git_hash(model_dir: str) -> None:
    """Warn when resuming a run that was started from different code: the
    first run writes ``model_dir/githash``, a later one compares with it."""
    cur = git_hash()
    if cur is None:
        return
    path = os.path.join(model_dir, "githash")
    if os.path.exists(path):
        with open(path) as f:
            saved = f.read().strip()
        if saved != cur:
            log.warning("git hash mismatch: run dir has %s, current is %s", saved[:8], cur[:8])
    else:
        os.makedirs(model_dir, exist_ok=True)
        with open(path, "w") as f:
            f.write(cur)
