"""A parameter tree as a ``torch.nn.Module``.

Every leaf of a port-layout tree (nested dicts and lists of arrays, ``None``
for a bias-free conv) is a buffer, so ``.to(device)`` moves them all, and
:attr:`TreeModule.params` gives back the nested tree of tensors that the
model functions take.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.checkpoint import _NONE_KEY, _flatten, _unflatten


class TreeModule(torch.nn.Module):
    def __init__(self, tree):
        super().__init__()
        self._nones: list = []
        flat = _flatten(tree, nones=self._nones)
        self._paths = list(flat)
        for i, a in enumerate(flat.values()):
            self.register_buffer(f"w{i}", torch.tensor(np.asarray(a, np.float32)))
        self._tree = None

    def _apply(self, fn, *args, **kwargs):
        self._tree = None
        return super()._apply(fn, *args, **kwargs)

    @property
    def device(self) -> torch.device:
        return self.w0.device

    @property
    def params(self):
        if self._tree is None:
            flat = {p: getattr(self, f"w{i}") for i, p in enumerate(self._paths)}
            if self._nones:
                flat[_NONE_KEY] = self._nones
            self._tree = _unflatten(flat)
        return self._tree
