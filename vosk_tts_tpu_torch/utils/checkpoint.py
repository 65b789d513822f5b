"""Bundle parameter (de)serialization without JAX.

The format is the JAX package's ``params.npz`` (vosk_tts_tpu/utils/
checkpoint.py): a flat ``.npz`` whose keys are tree paths joined with
'/'; a level whose keys are all digits is a list; ``__none_keys__`` lists
the paths of ``None`` leaves (bias-free convs). Arrays stay numpy here;
``utils/params.py`` turns them into the port's layouts and tensors.
"""

from __future__ import annotations

import numpy as np

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
