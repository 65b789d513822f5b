"""Batching shared by the port's VC (and, later, GPT-SoVITS) drivers
(vosk_tts_tpu/train/gpt_sovits_data.py). The GPT-SoVITS datasets of that
module come with GPT-SoVITS training (ROADMAP A.7)."""

from __future__ import annotations

import numpy as np

SEED = 1234  # the epoch's generator is default_rng(SEED + epoch)


class ShuffleBatcher:
    """Epoch-seeded batches for one process: the dataset's items sorted by
    ``dataset.lengths`` (where it has them), padded to a multiple of the
    batch by repeating the first items, cut into consecutive groups, the
    groups shuffled by ``default_rng(SEED + epoch)``. ``dataset.collate(idxs,
    rng)`` makes each batch from that epoch's generator, after the shuffle's
    draw, so the batches equal the JAX package's for the same seed (its
    host sharding aside: multi-card training is ROADMAP A.8)."""

    def __init__(self, dataset, batch_size: int):
        self.ds = dataset
        self.batch_size = batch_size
        self.order = list(range(len(dataset)))
        lengths = getattr(dataset, "lengths", None)
        if lengths:
            self.order.sort(key=lambda i: lengths[i])

    def num_batches(self) -> int:
        return max(len(self.order) // self.batch_size, 1) if self.order else 0

    def epoch(self, epoch: int):
        rng = np.random.default_rng(SEED + epoch)
        bs = self.batch_size
        order = self.order + self.order[: (bs - len(self.order) % bs) % bs]
        groups = [order[j * bs: (j + 1) * bs] for j in range(len(order) // bs)]
        for i in rng.permutation(len(groups)):
            g = groups[i]
            yield self.collate(g, rng)

    def collate(self, idxs, rng):
        return self.ds.collate(idxs, rng)
