"""A parameter tree as a ``torch.nn.Module``.

Every leaf of a port-layout tree (nested dicts and lists of arrays, ``None``
for a bias-free conv) is a buffer (serving) or, with ``trainable=True``, an
``nn.Parameter`` (training: the optimizer's), so ``.to(device)`` moves them
all, and :attr:`TreeModule.params` gives back the nested tree of tensors
that the model functions take. Leaves are registered in the tree's
flattening order (utils/checkpoint.py), so a state dict of one tree fits
every module made from a tree of the same structure.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.checkpoint import _NONE_KEY, _flatten, _unflatten


class TreeModule(torch.nn.Module):
    def __init__(self, tree, *, trainable: bool = False):
        super().__init__()
        self._nones: list = []
        flat = _flatten(tree, nones=self._nones)
        self._paths = list(flat)
        for i, a in enumerate(flat.values()):
            t = torch.tensor(np.asarray(a, np.float32))
            if trainable:
                self.register_parameter(f"w{i}", torch.nn.Parameter(t))
            else:
                self.register_buffer(f"w{i}", t)
        self._tree = None

    def _apply(self, fn, *args, **kwargs):
        self._tree = None
        return super()._apply(fn, *args, **kwargs)

    @property
    def device(self) -> torch.device:
        return self.w0.device

    def leaves(self) -> dict:
        """{tree path: tensor}, in the tree's flattening order."""
        return {p: getattr(self, f"w{i}") for i, p in enumerate(self._paths)}

    def numpy_tree(self):
        """The port-layout tree as numpy arrays (a copy on the host)."""
        flat = {p: t.detach().cpu().numpy() for p, t in self.leaves().items()}
        if self._nones:
            flat[_NONE_KEY] = self._nones
        return _unflatten(flat)

    @property
    def params(self):
        if self._tree is None:
            flat = self.leaves()
            if self._nones:
                flat[_NONE_KEY] = self._nones
            self._tree = _unflatten(flat)
        return self._tree
