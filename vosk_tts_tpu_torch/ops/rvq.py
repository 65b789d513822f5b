"""The SoVITS codebook's training buffers (vosk_tts_tpu/ops/rvq.py), in PyTorch.

The EuclideanCodebook of the reference (encodec's core_vq): k-means on the
first training batch seeds the codebook, then each step moves it by an
exponential moving average of the batch's assignments, with Laplace
smoothing of the cluster sizes. The buffers are a dict ``{"embed" (K, D),
"embed_avg" (K, D), "cluster_size" (K,), "inited" ()}`` of tensors, updated
by whole-tensor ops (no host read), outside autograd: the straight-through
estimator and the commit loss live in the model graph
(``models.gpt_sovits.sovits_forward_train``).

Distances are the JAX package's ``|x|^2 - 2 x.e + |e|^2``, then argmin
(the first of equal minima, as ``jnp.argmin``): another formula rounds
otherwise, and near-ties then flip codes, which over the k-means
iterations move the means. The random draws (the initial means' rows) take
``ids=`` to pin them, else come from a ``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.mesh import all_reduce_tensors, broadcast_tensors, gather_rows


def state_init(codebook_size: int, dim: int) -> dict:
    """The buffers before the first batch, on the CPU: zero embed, ``inited``
    0 (k-means initialisation, core_vq.py:121-139)."""
    embed = torch.zeros(codebook_size, dim)
    return {"embed": embed, "embed_avg": embed.clone(), "cluster_size": torch.zeros(codebook_size),
            "inited": torch.zeros(())}


def quantize(embed, x):
    """Nearest code ids: embed (K, D), x (..., D) -> (...) int64."""
    d = (x.square().sum(-1, keepdim=True) - 2 * torch.matmul(x, embed.T)
         + embed.square().sum(-1))
    return torch.argmin(d, dim=-1)


def sample_ids(n: int, num: int, *, generator=None, device=None):
    """The rows ``sample_vectors`` takes from n samples: the first ``num`` of
    a permutation when n >= num, else ``num`` uniform draws (core_vq.py:60-68)."""
    if n >= num:
        return torch.randperm(n, generator=generator, device=device)[:num]
    return torch.randint(0, n, (num,), generator=generator, device=device)


def sample_vectors(samples, num: int, *, generator=None, ids=None):
    """``num`` rows of ``samples`` (N, D): ``ids`` (num,) where given, else
    :func:`sample_ids` from ``generator``."""
    if ids is None:
        ids = sample_ids(samples.shape[0], num, generator=generator, device=samples.device)
    return samples[ids.to(samples.device).long()]


def _assign(means, samples):
    """(one-hot assignments (N, K), the cluster sizes (K,))."""
    onehot = F.one_hot(quantize(means, samples), means.shape[0]).to(samples.dtype)
    return onehot, onehot.sum(0)


def kmeans_run(samples, means0, num_iters: int = 10):
    """The k-means loop (core_vq.py:71-93) from the initial means (K, D):
    hard assignment, the mean of each cluster, an empty cluster keeps its
    previous mean. Returns (means, the last iteration's cluster sizes)."""
    means, bins = means0, None
    for _ in range(num_iters):
        onehot, bins = _assign(means, samples)
        new_means = torch.matmul(onehot.T, samples) / bins.clamp(min=1.0)[:, None]
        means = torch.where((bins == 0)[:, None], means, new_means)
    return means, bins


def kmeans(samples, num_clusters: int, num_iters: int = 10, max_samples: int = 500, *,
           generator=None, ids=None):
    """k-means over the first ``max_samples`` rows of ``samples`` from means
    drawn among them (:func:`sample_vectors`)."""
    samples = samples[:max_samples]
    means0 = sample_vectors(samples, num_clusters, generator=generator, ids=ids)
    return kmeans_run(samples, means0, num_iters)


@torch.no_grad()
def kmeans_init(state: dict, x, *, kmeans_iters: int = 10, max_samples: int = 500,
                generator=None, ids=None, dp=None) -> dict:
    """init_embed_ (core_vq.py:141-152) of a state that is not inited:
    k-means over the flattened batch features x (N, D) seeds embed,
    embed_avg and the cluster sizes, and the state becomes inited.

    ``dp`` (the data axis of a data-parallel step, parallel/mesh.py): k-means
    runs on every rank over every rank's rows gathered in rank order (the
    global batch's flattened rows; the ranks' counts may differ), from the
    initial means that ``ids`` pins or, without it, that the axis root
    draws: every rank gets equal means."""
    if dp is not None:
        x = gather_rows(x, dp)
        if ids is None:
            ids = sample_ids(min(x.shape[0], max_samples), state["embed"].shape[0],
                             generator=generator, device=x.device)
            broadcast_tensors([ids], dp)
    embed, bins = kmeans(x, state["embed"].shape[0], kmeans_iters, max_samples,
                         generator=generator, ids=ids)
    return {"embed": embed, "embed_avg": embed.clone(), "cluster_size": bins.to(x.dtype),
            "inited": torch.ones_like(state["inited"])}


def maybe_kmeans_init(state: dict, x, *, kmeans_iters: int = 10, max_samples: int = 500,
                      generator=None, ids=None) -> dict:
    """:func:`kmeans_init` where ``state`` is not inited; an inited state
    comes back as it is. The branch is one host read of ``inited``: a
    trainer that keeps its own copy of the flag calls :func:`kmeans_init`."""
    if bool(state["inited"] > 0):
        return state
    return kmeans_init(state, x, kmeans_iters=kmeans_iters, max_samples=max_samples,
                       generator=generator, ids=ids)


def _laplace_smoothing(x, n_categories: int, epsilon: float):
    return (x + epsilon) / (x.sum() + n_categories * epsilon)


@torch.no_grad()
def ema_step(state: dict, x, *, decay: float = 0.99, epsilon: float = 1e-5, dp=None) -> dict:
    """One training step's transition of an inited state (core_vq.py:207-231)
    given the flattened batch features x (N, D): codes by the current embed,
    cluster_size and embed_avg moved by an EMA of the batch's counts and
    sums, then embed = embed_avg / the Laplace-smoothed cluster sizes.

    The reference (and the JAX package) first replaces the codes whose EMA
    cluster size is below ``threshold_ema_dead_code`` by random batch rows,
    in ``embed`` only; the same call then overwrites ``embed`` with
    embed_avg / n, and the codes were taken before the replacement, so the
    replacement reaches nothing. This port leaves that draw out: its result
    equals JAX's ``ema_step`` at any threshold.

    ``dp`` (as in :func:`kmeans_init`): the batch's counts and sums are
    summed over the axis before the decay, so every rank takes the global
    batch's step."""
    k = state["embed"].shape[0]
    onehot, counts = _assign(state["embed"], x)
    sums = torch.matmul(onehot.T, x)
    all_reduce_tensors([counts, sums], dp)
    cluster_size = state["cluster_size"] * decay + counts * (1 - decay)
    embed_avg = state["embed_avg"] * decay + sums * (1 - decay)
    n = _laplace_smoothing(cluster_size, k, epsilon) * cluster_size.sum()
    return {"embed": embed_avg / n[:, None], "embed_avg": embed_avg,
            "cluster_size": cluster_size, "inited": state["inited"]}


def train_update(state: dict, x, *, decay: float = 0.99, epsilon: float = 1e-5,
                 kmeans_iters: int = 10, max_samples: int = 500, generator=None,
                 ids=None) -> dict:
    """A step's whole buffer update: k-means on the first batch
    (:func:`maybe_kmeans_init`, ``ids`` pinning its initial means), then
    :func:`ema_step`. x: (N, D) flattened features, outside autograd."""
    state = maybe_kmeans_init(state, x, kmeans_iters=kmeans_iters, max_samples=max_samples,
                              generator=generator, ids=ids)
    return ema_step(state, x, decay=decay, epsilon=epsilon)
