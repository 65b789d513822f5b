"""The process group, the (data, model) grid of ranks and the collectives of
the global-batch step (vosk_tts_tpu/parallel/mesh.py), over
``torch.distributed``.

In the JAX package a data-parallel step is the global-batch step: XLA
computes every loss over the whole global batch. Here each rank holds its
rows and computes its *share* of each global loss, so that the shares sum
to it over the ``data`` axis; :func:`reduce_grads` then sums the gradients
(no mean), and every rank holds the gradient of the global-batch loss:

  * a mean over equal-shaped shards is the local mean / the axis size
    (:func:`mean_share`);
  * a masked normalizer (a mask sum, a token count) is summed over the axis
    without a gradient (:func:`total`);
  * a term of global sums, medians or norms (the TPRLS term, the spectral
    convergence) is computed whole on every rank from differentiable
    collectives (:func:`all_sum`, :func:`gather_rows`, whose backward sums
    the ranks' gradients), then divided by the axis size.

Every collective is built from ``all_reduce`` and ``broadcast``, the two
that gloo runs on CUDA tensors: two ranks that share one card use gloo
(NCCL refuses them), ranks on cards of their own NCCL, CPU ranks gloo.
Axes with one rank still run their collectives (identities), so a
one-rank job takes the distributed code path; ``None`` in place of an axis
is the single-process step, with no collective at all.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..utils.precision import full_float32

#: a collective or a join that waits longer than this raises on every rank
TIMEOUT = datetime.timedelta(seconds=600)
#: the size of a bucket of flattened gradients (one collective each)
BUCKET_BYTES = 32 * 2**20


def launched_by_torchrun() -> bool:
    """Whether torchrun's environment (RANK, WORLD_SIZE) is set."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, device: str = "cuda",
               timeout: datetime.timedelta = TIMEOUT) -> torch.device:
    """Join the process group (the counterpart of ``jax.distributed.
    initialize``) and return this rank's device: ``cuda:LOCAL_RANK``, or the
    CPU for ``device="cpu"``.

    Without ``coordinator`` the group comes from torchrun's environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK). Else
    ``coordinator`` is ``host:port`` (rank 0 serves the store there) or an
    ``init_method`` URL (``file://PATH``, a store on a shared file), with
    ``num_processes`` and ``process_id``. CUDA ranks use NCCL on
    ``cuda:(LOCAL_RANK mod the cards)``, set before NCCL starts; CPU ranks,
    and ranks that share a card (LOCAL_WORLD_SIZE larger than the visible
    cards: NCCL refuses them), use gloo. A group that is already up is
    kept. Each rank turns TF32 off (utils/precision.py)."""
    full_float32()
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    if coordinator is None:
        if not launched_by_torchrun():
            raise RuntimeError("no coordinator given and no torchrun environment (RANK, "
                               "WORLD_SIZE) to join the process group from")
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = "env://"
    else:
        rank, world = int(process_id), int(num_processes)
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    if device == "cuda":
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)) % cards)
        torch.cuda.set_device(dev)
        shared = int(os.environ.get("LOCAL_WORLD_SIZE", 1)) > cards
        backend = "gloo" if shared else "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                                timeout=timeout,
                                **({"device_id": dev} if backend == "nccl" else {}))
    return dev


def shutdown() -> None:
    """Leave the process group (after a barrier), where one is up."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


class Axis:
    """One axis of the grid: the ranks that share every other coordinate,
    their group, this rank's ``index`` among them and their ``size``."""

    def __init__(self, ranks, group):
        self.ranks = list(ranks)
        self.group = group
        self.size = len(self.ranks)
        self.index = self.ranks.index(dist.get_rank())

    @property
    def root(self) -> int:
        """The global rank of the axis's first member (a broadcast's source)."""
        return self.ranks[0]


class Grid:
    """The (data, model) grid of ranks, the counterpart of ``make_mesh``:
    rank = data index x n_model + model index (the JAX mesh's row-major
    device order). ``data`` is the axis a rank's gradients are reduced over,
    ``model`` the one a tensor-parallel generator is sharded over."""

    def __init__(self, n_data: int, n_model: int):
        world = dist.get_world_size()
        if n_data * n_model != world:
            raise ValueError(f"a {n_data} x {n_model} grid needs {n_data * n_model} ranks, "
                             f"not {world}")
        rank = dist.get_rank()
        self.n_data, self.n_model = n_data, n_model
        # every rank makes every group, in the same order
        for d in range(n_data):
            ranks = [d * n_model + m for m in range(n_model)]
            group = dist.new_group(ranks)
            if rank in ranks:
                self.model = Axis(ranks, group)
        for m in range(n_model):
            ranks = [d * n_model + m for d in range(n_data)]
            group = dist.new_group(ranks)
            if rank in ranks:
                self.data = Axis(ranks, group)


def make_grid(n_data: int | None = None, n_model: int = 1) -> Grid:
    """The grid over every rank of the group (``n_data`` defaults to the
    world size / ``n_model``)."""
    if n_data is None:
        n_data = dist.get_world_size() // n_model
    return Grid(n_data, n_model)


# ---------------------------------------------------------------------------
# Collectives of the step
# ---------------------------------------------------------------------------


def size(axis: Axis | None) -> int:
    return 1 if axis is None else axis.size


def summed(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """A new tensor: ``x`` summed over the axis (no autograd)."""
    x = x.contiguous().clone()
    dist.all_reduce(x, group=axis.group)
    return x


class _AllSum(torch.autograd.Function):
    """The sum over the axis; the backward sums the gradients over it."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return summed(x, axis)

    @staticmethod
    def backward(ctx, g):
        return summed(g, ctx.axis), None


def all_sum(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """The sum of ``x`` over the axis, differentiable: the backward sums the
    ranks' gradients (each rank's share of a global loss)."""
    return x if axis is None else _AllSum.apply(x, axis)


@torch.no_grad()
def total(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """The sum of ``x`` over the axis without a gradient (a normalizer)."""
    return x if axis is None else summed(x.detach(), axis)


def mean_share(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """This rank's share of the mean over the global batch of a tensor whose
    shard has the same shape on every rank: the local mean / the axis size."""
    m = torch.mean(x)
    return m if axis is None else m / axis.size


def gather_rows(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0 in rank order, the row
    counts free to differ (exchanged first); differentiable, the backward
    summing each row's gradients over the ranks."""
    if axis is None:
        return x
    counts = x.new_zeros(axis.size, dtype=torch.float64)
    counts[axis.index] = x.shape[0]
    counts = [int(c) for c in total(counts, axis).tolist()]
    before, after = sum(counts[:axis.index]), sum(counts[axis.index + 1:])
    buf = torch.cat([x.new_zeros((before, *x.shape[1:])), x, x.new_zeros((after, *x.shape[1:]))])
    return _AllSum.apply(buf, axis)


@torch.no_grad()
def reduce_metrics(metrics: dict, axis: Axis | None) -> dict:
    """Each metric (a rank's share of a global loss) summed over the axis in
    one collective: the global value on every rank."""
    if axis is None or not metrics:
        return metrics
    flat = torch.stack([v.detach().float() for v in metrics.values()])
    dist.all_reduce(flat, group=axis.group)
    return dict(zip(metrics, flat.unbind()))


def _buckets(tensors):
    bucket, nbytes = [], 0
    for t in tensors:
        if bucket and (t.dtype != bucket[0].dtype or t.device != bucket[0].device
                       or nbytes + t.numel() * t.element_size() > BUCKET_BYTES):
            yield bucket
            bucket, nbytes = [], 0
        bucket.append(t)
        nbytes += t.numel() * t.element_size()
    if bucket:
        yield bucket


@torch.no_grad()
def all_reduce_tensors(tensors, axis: Axis | None) -> None:
    """Sum each tensor over the axis in place, flattened into buckets (a few
    large collectives, not one a tensor)."""
    if axis is None:
        return
    for bucket in _buckets(list(tensors)):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=axis.group)
        torch._foreach_copy_(bucket, [f.view_as(t) for f, t in
                                      zip(flat.split([t.numel() for t in bucket]), bucket)])


def reduce_grads(params, axis: Axis | None) -> None:
    """Sum the parameters' gradients over the axis in place: every rank's
    share of the global loss's gradient, whole on every rank. Every
    parameter must hold a gradient (``vits2_train.fill_missing_grads``
    first), so that every rank reduces the same list of tensors."""
    if axis is None:
        return
    params = list(params)
    missing = sum(p.grad is None for p in params)
    if missing:
        raise ValueError(f"{missing} parameters hold no gradient; fill them before the reduction")
    all_reduce_tensors([p.grad for p in params], axis)


@torch.no_grad()
def broadcast_tensors(tensors, axis: Axis | None) -> None:
    """Copy the axis root's tensors into every rank's, in place, bucketed."""
    if axis is None:
        return
    for bucket in _buckets(list(tensors)):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.broadcast(flat, src=axis.root, group=axis.group)
        torch._foreach_copy_(bucket, [f.view_as(t) for f, t in
                                      zip(flat.split([t.numel() for t in bucket]), bucket)])


def replicate_params(module: torch.nn.Module, axis: Axis | None) -> None:
    """The counterpart of ``replicate_params``: the axis root's parameters
    and buffers broadcast into every rank's module."""
    broadcast_tensors([*module.parameters(), *module.buffers()], axis)


def optimizer_tensors(opt: torch.optim.Optimizer) -> list:
    """The tensors of an optimizer's state on its parameters' devices (a
    step count kept on the host is left out), in the order of its
    parameters."""
    out = []
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state.get(p, {})
            out += [st[k] for k in sorted(st)
                    if isinstance(st[k], torch.Tensor) and st[k].device == p.device]
    return out
