"""Model registry: list / resolve / download / unzip bundles (the port's
own copy of vosk_tts_tpu/registry.py; standard library only).

Mirrors the reference's registry logic (vosk_tts/model.py:17-127): a JSON
model list (entries with "name", "lang", "type", "obsolete"), zip archives
named ``<name>.zip`` next to it, a local cache directory search path, and
by-name / by-lang resolution (lang picks the non-obsolete "small" entry).

The transport is pluggable: URLs are fetched with ``urllib`` by default —
which handles ``file://`` registries out of the box (production
deployments point VOSK_TTS_REGISTRY at an https mirror). No tqdm/requests
dependencies; progress goes to logging.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
from pathlib import Path
from urllib.request import urlopen
from zipfile import ZipFile

log = logging.getLogger("vosk_tts_tpu_torch.registry")

#: base URL of the model registry; model list at <base>/model-list.json,
#: archives at <base>/<name>.zip (reference MODEL_PRE_URL semantics)
def registry_url() -> str | None:
    return os.getenv("VOSK_TTS_REGISTRY")


def _read_url(url: str, fetcher=None) -> bytes:
    if fetcher is not None:
        return fetcher(url)
    with urlopen(url, timeout=10) as r:
        return r.read()


def model_list(base_url: str | None = None, fetcher=None) -> list[dict]:
    base = base_url or registry_url()
    if not base:
        return []
    data = _read_url(base.rstrip("/") + "/model-list.json", fetcher)
    return json.loads(data)


def select_by_name(models: list[dict], name: str) -> dict | None:
    for m in models:
        if m.get("name") == name:
            return m
    return None


def select_by_lang(models: list[dict], lang: str) -> dict | None:
    """Reference rule (model.py:98-101): non-obsolete 'small' entry for lang."""
    for m in models:
        if (m.get("lang") == lang and m.get("type") == "small"
                and str(m.get("obsolete", "false")) == "false"):
            return m
    return None


def download_model(name: str, dest_dir, base_url: str | None = None,
                   fetcher=None) -> Path:
    """Fetch <base>/<name>.zip, extract into dest_dir, remove the zip.
    Returns the extracted bundle directory (dest_dir/name)."""
    base = base_url or registry_url()
    if not base:
        raise FileNotFoundError(
            f"model {name!r} is not installed locally and no registry is "
            "configured (set VOSK_TTS_REGISTRY)")
    dest = Path(dest_dir)
    dest.mkdir(parents=True, exist_ok=True)
    zip_path = dest / f"{name}.zip"
    url = base.rstrip("/") + f"/{name}.zip"
    log.info("downloading %s", url)
    zip_path.write_bytes(_read_url(url, fetcher))
    try:
        with ZipFile(zip_path) as zf:
            root = dest.resolve()
            for member in zf.namelist():
                # refuse path traversal before extracting (a path test, not a
                # string prefix: "<dest>-evil/x" does not lie under dest)
                if not (dest / member).resolve().is_relative_to(root):
                    raise ValueError(f"unsafe path in archive: {member}")
            zf.extractall(dest)
    finally:
        zip_path.unlink(missing_ok=True)
    out = dest / name
    if not out.is_dir():
        raise FileNotFoundError(f"archive {name}.zip did not contain {name}/")
    return out


def resolve(model_name: str | None, lang: str | None, search_dirs,
            base_url: str | None = None, fetcher=None) -> Path:
    """Local search first (reference model.py:72-104), then registry."""
    for d in search_dirs:
        if d is None or not Path(d).is_dir():
            continue
        for name in sorted(os.listdir(d)):
            if model_name is not None and name == model_name:
                return Path(d) / name
            if model_name is None and lang and re.match(
                    rf"vosk-model(-small)?(-tts)?-{lang}", name):
                return Path(d) / name

    models = model_list(base_url, fetcher)
    entry = (select_by_name(models, model_name) if model_name
             else select_by_lang(models, lang or ""))
    if entry is None:
        raise FileNotFoundError(
            f"no model for name={model_name!r} lang={lang!r}: not installed "
            f"in {[d for d in search_dirs if d]} and not in the registry")
    cache = next((d for d in reversed(search_dirs) if d), None)
    if cache is None:
        raise FileNotFoundError("no writable model cache directory configured")
    return download_model(entry["name"], cache, base_url, fetcher)
