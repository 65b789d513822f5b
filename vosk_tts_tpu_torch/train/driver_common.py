"""Shared pieces of the port's training drivers (vosk_tts_tpu/train/
driver_common.py): the batch on the device, the epoch loop with its log
lines and ``STATE_{step}.pt`` saves, resume from the latest full state, the
metrics line of the log, and joining the process group of a data-parallel
run.

A data-parallel run is N processes, one a card (or CPU ranks over gloo),
each with its rows of the global batch; the step sums the ranks' gradients
(parallel/mesh.py), so every rank holds the same state. Only rank 0 logs
and writes ``STATE_*.pt`` (a barrier follows each save, so that no rank
reads a checkpoint before it is whole); on resume every rank loads the same
file, then rank 0's parameters and optimizer state are broadcast."""

from __future__ import annotations

import argparse
import logging
import time

import torch
import torch.distributed as dist

from ..api import resolve_device
from ..parallel import mesh as M
from ..utils import checkpoint as ckpt

log = logging.getLogger("vosk_tts_tpu_torch.train")


def to_device(batch: dict, device) -> dict:
    """A collated numpy batch as tensors on ``device`` (ids and lengths int64)."""
    out = {}
    for k, a in batch.items():
        t = torch.from_numpy(a)
        out[k] = (t.long() if k in ("x", "sid") else t).to(device, non_blocking=True)
    return out


def is_main() -> bool:
    """Rank 0 of a data-parallel run, or the one process of a run."""
    return not dist.is_initialized() or dist.get_rank() == 0


def add_distributed_args(ap: argparse.ArgumentParser) -> None:
    """The JAX driver's flags of a multi-host run."""
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group from torchrun's environment (RANK, "
                         "WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK)")
    ap.add_argument("--dist-coordinator", default=None,
                    help="host:port of rank 0's store (or an init_method URL, file://PATH)")
    ap.add_argument("--dist-num-processes", type=int, default=None)
    ap.add_argument("--dist-process-id", type=int, default=None)


def join(args) -> tuple:
    """(this process's device, the data axis or None, whether this call
    made the group). With ``--dist-coordinator``, ``--distributed`` or
    under torchrun's environment the process joins the group
    (parallel/mesh.initialize: the card ``cuda:LOCAL_RANK``, or CPU ranks
    over gloo with ``--device cpu``; a group the caller made is kept) and
    every rank is on the data axis; else one process on ``--device``
    (default: the card). The driver leaves a group it made
    (``mesh.shutdown``) when it is done."""
    if not (args.dist_coordinator or args.distributed or M.launched_by_torchrun()):
        return resolve_device(args.device), None, False
    made = not dist.is_initialized()
    device = M.initialize(args.dist_coordinator, args.dist_num_processes, args.dist_process_id,
                          device="cpu" if args.device == "cpu" else "cuda")
    grid = M.make_grid()
    log.info("rank %d of %d on %s", dist.get_rank(), dist.get_world_size(), device)
    return device, grid.data, made


def rank_seed(seed: int, dp) -> int:
    """A rank's seed for its generator: the run's seed + its index on the
    data axis (each rank draws its own rows' noise)."""
    return seed + (0 if dp is None else dp.index)


def host_shard(dp) -> dict:
    """The batcher's ``host_id``/``num_hosts`` of this rank of the data axis."""
    return {"host_id": 0, "num_hosts": 1} if dp is None else {"host_id": dp.index,
                                                              "num_hosts": dp.size}


def save_state(model_dir: str, state, epoch: int) -> None:
    """``STATE_{step}.pt``: the whole training state and the epoch."""
    ckpt.save_full_state(model_dir, "STATE", state.step, {**state.state_dict(), "epoch": epoch})
    log.info("saved checkpoint at step %d", state.step)


def train_loop(*, model_dir: str, state, step_fn, batcher, epochs: int, device,
               start_epoch: int = 0, log_interval: int = 100, save_interval: int = 1000,
               max_steps: int | None = None, generator=None, save=save_state, set_lr=None,
               after_step=None) -> dict:
    """The epoch loop of every driver: ``set_lr(state, epoch)`` at each
    epoch's start where given; for each batch of ``batcher.epoch(epoch)``
    one ``step_fn(state, batch, generator=)`` (which advances
    ``state.step``), then ``after_step(state)`` where given, a log line every
    ``log_interval`` steps and ``save(model_dir, state, epoch)`` every
    ``save_interval``; a final save at the end, or once ``state.step``
    reaches ``max_steps`` (with the epoch it was in). Returns the last
    step's metrics as floats (empty where no step ran). In a data-parallel
    run only rank 0 logs and saves, and every rank waits for each save."""
    main = is_main()

    def save_all(st, ep):
        if main:
            save(model_dir, st, ep)
        if dist.is_initialized():
            dist.barrier()

    cut = max_steps is not None and state.step >= max_steps
    epoch, metrics = start_epoch, {}
    for epoch in range(start_epoch, epochs):
        if cut:
            break
        if set_lr is not None:
            set_lr(state, epoch)
        t_epoch = time.time()
        for batch in batcher.epoch(epoch):
            metrics = step_fn(state, to_device(batch, device), generator=generator)
            if after_step is not None:
                after_step(state)
            if main and state.step % log_interval == 0:
                log.info("epoch %d step %d %s", epoch, state.step, format_metrics(metrics))
            if state.step % save_interval == 0:
                save_all(state, epoch)
            cut = max_steps is not None and state.step >= max_steps
            if cut:
                break
        if main:
            log.info("epoch %d done in %.1f s", epoch, time.time() - t_epoch)
        if cut:
            break
    else:
        epoch = epochs
    save_all(state, epoch)
    return format_metrics(metrics) if metrics else {}


def resume_state(model_dir: str, state, dp=None) -> int | None:
    """Load the latest ``STATE_*.pt`` of ``model_dir`` into ``state`` (a
    TrainState); returns the epoch to start from, or None where there is no
    checkpoint. With ``dp`` (the data axis) every rank loads the file, then
    the axis root's parameters and optimizer state are broadcast (a fresh
    state's too: every rank starts from the root's)."""
    saved = ckpt.load_full_state(model_dir, "STATE", map_location=next(
        iter(state.params.values())).device)
    if saved is not None:
        state.load_state_dict(saved)
    for net, module in state.params.items():
        M.replicate_params(module, dp)
        M.broadcast_tensors(M.optimizer_tensors(state.opt[net]), dp)
    if saved is None:
        return None
    log.info("resumed from step %d epoch %d", state.step, saved["epoch"])
    return int(saved["epoch"])


def format_metrics(metrics: dict) -> dict:
    """Host floats of a step's metrics (one synchronisation)."""
    values = torch.stack([v.float() for v in metrics.values()]).cpu().tolist()
    return {k: round(v, 4) for k, v in zip(metrics, values)}
