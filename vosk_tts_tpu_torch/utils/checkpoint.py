"""Bundle parameter (de)serialization without JAX, and training checkpoints.

The bundle format is the JAX package's ``params.npz`` (vosk_tts_tpu/utils/
checkpoint.py): a flat ``.npz`` whose keys are tree paths joined with
'/'; a level whose keys are all digits is a list; ``__none_keys__`` lists
the paths of ``None`` leaves (bias-free convs). Arrays stay numpy here;
``utils/params.py`` turns them into the port's layouts and tensors.

Training writes two streams into its model directory, as the JAX
package's driver does: ``G_{step}.npz`` (+ ``.meta.json``), the generator
in that bundle format and key scheme (:func:`save_train_state`), and the
port's own ``STATE_{step}.pt``, the whole training state for resume
(params, optimizer state dicts, step, epoch; :func:`save_full_state`,
``torch.save`` of tensors and plain containers, read back with
``weights_only=True``).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

_NONE_KEY = "__none_keys__"


def _flatten(tree, prefix="", nones=None):
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
        return out
    for k, v in items:
        if v is None:
            if nones is not None:
                nones.append(f"{prefix}{k}")
            continue
        out.update(_flatten(v, f"{prefix}{k}/", nones))
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, value in flat.items():
        if key == _NONE_KEY:
            continue
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    root = listify(root)

    if _NONE_KEY in flat:
        for key in flat[_NONE_KEY]:
            parts = str(key).split("/")
            node = root
            for p in parts[:-1]:
                node = node[int(p)] if isinstance(node, list) else node[p]
            leaf = parts[-1]
            if isinstance(node, list):
                node[int(leaf)] = None
            else:
                node[leaf] = None
    return root


def save_params(path, params) -> None:
    """Write a tree of numpy arrays (or anything ``np.asarray`` takes)."""
    nones: list = []
    flat = _flatten(params, nones=nones)
    if nones:
        flat[_NONE_KEY] = np.asarray(nones)
    np.savez(path, **flat)


def load_params(path):
    """Read a ``params.npz`` back into a nested dict/list tree of numpy arrays."""
    with np.load(path, allow_pickle=False) as data:
        return _unflatten({k: data[k] for k in data.files})


def latest_checkpoint(dirname, prefix: str = "G_", suffix: str = ".npz") -> str | None:
    """The ``{prefix}{step}{suffix}`` file of ``dirname`` with the largest step."""
    best, best_step = None, -1
    if not os.path.isdir(dirname):
        return None
    for name in os.listdir(dirname):
        if name.startswith(prefix) and name.endswith(suffix):
            try:
                step = int(name[len(prefix): -len(suffix)])
            except ValueError:
                continue
            if step > best_step:
                best, best_step = os.path.join(dirname, name), step
    return best


def save_train_state(dirname, tag: str, step: int, params) -> None:
    """``{tag}_{step}.npz`` (a bundle-layout tree, :func:`save_params`) and
    ``{tag}_{step}.meta.json``, as the JAX package's ``save_train_state``
    writes them (without optimizer state)."""
    os.makedirs(dirname, exist_ok=True)
    save_params(os.path.join(dirname, f"{tag}_{step}.npz"), params)
    with open(os.path.join(dirname, f"{tag}_{step}.meta.json"), "w") as f:
        json.dump({"step": step}, f)


def save_full_state(dirname, tag: str, step: int, state: dict) -> None:
    """Write ``{tag}_{step}.pt``: ``state`` holds tensors, state dicts and
    plain values."""
    os.makedirs(dirname, exist_ok=True)
    path = os.path.join(dirname, f"{tag}_{step}.pt")
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)


def load_full_state(dirname, tag: str, *, map_location=None):
    """The latest ``{tag}_*.pt`` state, or None."""
    path = latest_checkpoint(dirname, prefix=f"{tag}_", suffix=".pt")
    if path is None:
        return None
    return torch.load(path, map_location=map_location, weights_only=True)
