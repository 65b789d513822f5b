"""Tensor-parallel HiFiGAN-family generator (vosk_tts_tpu/parallel/tp.py),
over the ``model`` axis of the grid (parallel/mesh.py).

The JAX package emits seed shardings for the generator's weights in the
Megatron column/row pattern and lets GSPMD place the collectives. Here the
weights are cut by the same rules and :class:`TensorParallel` places the
collectives itself, inside ``vits2.generator_apply`` (its ``tp=``
argument), conv by conv:

  * column-parallel (output channels sharded): ``conv_pre``, ``cond``,
    ``ups[i]``, resblock1 ``convs2``; the input is whole (gathered where it
    is channel-sharded), the output channel-sharded;
  * row-parallel (input channels sharded, the bias whole): resblock1
    ``convs1``, resblock2 ``convs``, ``conv_post``; the input is
    channel-sharded (this rank's slice taken where it is whole), the
    partial outputs summed over the axis;
  * replicated: a weight whose sharded dimension the axis size does not
    divide, and ``multistream_conv_post``.

Every rank of a ``model`` axis holds the same rows and computes the same
loss, so the collectives are Megatron's: a whole activation that enters a
column-parallel conv passes through an identity whose backward sums the
ranks' gradients; the sum of a row-parallel conv's partial outputs passes
its gradient through unchanged; a gather's backward takes this rank's
slice, a slice's backward gathers. Each is an ``all_reduce`` (a gather is
the sum of zero-filled buffers, each rank's slice in its place), the one
collective gloo also runs on CUDA tensors. A sharded weight's gradient is
this rank's slice of the whole gradient; a replicated weight's gradient is
whole and equal on every rank of the axis. Activations are channels-last,
so a channel slice is along the last dimension.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.conv import conv1d, conv_transpose1d
from .mesh import Axis, summed

COL, ROW = "col", "row"


def conv(tp, keys, x, p, *, transpose: bool = False, **kw):
    """The conv ``p`` (a ConvTranspose1d with ``transpose``): plain where
    ``tp`` is None, else the tensor-parallel conv named ``keys``
    (:meth:`TensorParallel.conv`)."""
    if tp is not None:
        return tp.conv(keys, x, p, transpose=transpose, **kw)
    return (conv_transpose1d if transpose else conv1d)(x, p["w"], p["b"], **kw)


def _spec(w_shape, dim: int, n: int, kind: str):
    """``kind`` where the axis size divides the dimension, else None
    (replicated)."""
    return kind if w_shape[dim] % n == 0 else None


def generator_tp_specs(gen_params, n: int):
    """The counterpart of ``generator_tp_shardings`` for a port-layout
    generator tree (Conv1d (O, I, K), 1x1 conv (O, I), ConvTranspose1d
    (I, O, K)): a tree with the generator's conv dicts as keys and, for
    each conv, ``"col"``, ``"row"`` or None (replicated). Shapes decide as
    in the JAX package: the JAX (K, I, O) weight's O (column) or I (row)
    dimension must divide by ``n``."""
    col = lambda p: _spec(p["w"].shape, 0, n, COL)
    row = lambda p: _spec(p["w"].shape, 1, n, ROW)
    specs = {"conv_pre": col(gen_params["conv_pre"]),
             "ups": [_spec(u["w"].shape, 1, n, COL) for u in gen_params["ups"]],
             "resblocks": [], "conv_post": row(gen_params["conv_post"])}
    for rb in gen_params["resblocks"]:
        if "convs1" in rb:
            specs["resblocks"].append({"convs1": [row(c) for c in rb["convs1"]],
                                       "convs2": [col(c) for c in rb["convs2"]]})
        else:
            specs["resblocks"].append({"convs": [row(c) for c in rb["convs"]]})
    if "cond" in gen_params:
        specs["cond"] = col(gen_params["cond"])
    return specs


def _cut(a, dim: int, index: int, n: int):
    step = a.shape[dim] // n
    sl = [slice(None)] * a.ndim
    sl[dim] = slice(index * step, (index + 1) * step)
    out = a[tuple(sl)]
    return np.ascontiguousarray(out) if isinstance(out, np.ndarray) else out.contiguous()


def shard_generator_params(gen_params, axis: Axis):
    """This rank's part of a port-layout generator tree (numpy or tensor
    leaves): each sharded weight cut to its 1/n along the dimension its
    spec names (a column conv's bias with it), every other leaf whole.
    Returns (the local tree, the :class:`TensorParallel` that
    ``generator_apply(..., tp=)`` takes with it)."""
    n, r = axis.size, axis.index
    specs = generator_tp_specs(gen_params, n)

    def cut(p, spec, transpose=False):
        if spec is None:
            return p
        if spec == COL:
            out = {"w": _cut(p["w"], 1 if transpose else 0, r, n)}
            if "b" in p:
                out["b"] = None if p["b"] is None else _cut(p["b"], 0, r, n)
            return out
        return {"w": _cut(p["w"], 0 if transpose else 1, r, n),
                **({"b": p["b"]} if "b" in p else {})}

    local = dict(gen_params)
    local["conv_pre"] = cut(gen_params["conv_pre"], specs["conv_pre"])
    local["ups"] = [cut(u, s, True) for u, s in zip(gen_params["ups"], specs["ups"])]
    local["resblocks"] = [{k: [cut(c, s) for c, s in zip(rb[k], sp[k])] for k in rb}
                          for rb, sp in zip(gen_params["resblocks"], specs["resblocks"])]
    local["conv_post"] = cut(gen_params["conv_post"], specs["conv_post"])
    if "cond" in gen_params:
        local["cond"] = cut(gen_params["cond"], specs["cond"])
    return local, TensorParallel(axis, specs)


# ---------------------------------------------------------------------------
# The collectives (all_reduce only), channels-last
# ---------------------------------------------------------------------------


def _pad_own(x, axis):
    """A zero buffer of the whole channel count with x in this rank's slice."""
    c = x.shape[-1]
    return torch.cat([x.new_zeros((*x.shape[:-1], c * axis.index)), x,
                      x.new_zeros((*x.shape[:-1], c * (axis.size - axis.index - 1)))], dim=-1)


def _own(x, axis):
    c = x.shape[-1] // axis.size
    return x[..., axis.index * c:(axis.index + 1) * c].contiguous()


class _Copy(torch.autograd.Function):
    """Identity; the backward sums the gradient over the axis."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return summed(g, ctx.axis), None


class _Reduce(torch.autograd.Function):
    """The sum over the axis; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, axis):
        return summed(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """Channel shards -> the whole; the backward takes this rank's slice."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return summed(_pad_own(x, axis), axis)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.axis), None


class _Slice(torch.autograd.Function):
    """The whole -> this rank's channel slice; the backward gathers."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _own(x, axis)

    @staticmethod
    def backward(ctx, g):
        return summed(_pad_own(g, ctx.axis), ctx.axis), None


class TensorParallel:
    """The generator's convs over the ``model`` axis, by the specs of
    :func:`generator_tp_specs` (``specs`` a subtree of them, as
    :meth:`scope` narrows it for a resblock). A conv is named by its keys
    under the specs (``("ups", 0)``, ``("convs1", 1)``)."""

    def __init__(self, axis: Axis, specs):
        self.axis, self.specs = axis, specs

    def scope(self, *keys) -> "TensorParallel":
        return TensorParallel(self.axis, self._at(keys))

    def _at(self, keys):
        node = self.specs
        for k in keys:
            node = node[k]
        return node

    def whole(self, x, channels: int):
        """``x`` with ``channels`` channels: gathered where it is sharded."""
        if x.shape[-1] == channels:
            return x
        return _Gather.apply(x, self.axis)

    def sharded(self, x, channels: int):
        """``x`` with this rank's ``channels``: sliced where it is whole."""
        if x.shape[-1] == channels:
            return x
        return _Slice.apply(x, self.axis)

    def conv(self, keys, x, p, *, transpose: bool = False, **kw):
        """The conv ``p`` (a Conv1d, 1x1 or, with ``transpose``, a
        ConvTranspose1d) named ``keys``, on an activation whole or
        channel-sharded; ``kw`` as ``conv1d``/``conv_transpose1d`` take."""
        fn = conv_transpose1d if transpose else conv1d
        w, b = p["w"], p.get("b")
        in_dim = 0 if transpose else 1
        spec = self._at(keys)
        if spec == ROW:
            y = _Reduce.apply(fn(self.sharded(x, w.shape[in_dim]), w, None, **kw), self.axis)
            return y if b is None else y + b
        x = self.whole(x, w.shape[in_dim])
        if spec == COL:
            x = _Copy.apply(x, self.axis)
        return fn(x, w, b, **kw)

    def add(self, a, b):
        """a + b, the whole one of the two sliced where the other is sharded."""
        if a.shape[-1] == b.shape[-1]:
            return a + b
        if a.shape[-1] > b.shape[-1]:
            return self.sharded(a, b.shape[-1]) + b
        return a + self.sharded(b, a.shape[-1])
