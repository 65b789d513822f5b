"""GPT-SoVITS training driver (vosk_tts_tpu/train/run_gpt_sovits.py), on the
card.

Usage:
  python -m vosk_tts_tpu_torch.train.run_gpt_sovits --stage s1 -c config.json -m DIR \
      [--epochs N] [--max-steps N] [--device cpu]
  python -m vosk_tts_tpu_torch.train.run_gpt_sovits --stage s2 -c config.json -m DIR ...

``config.json`` has the JAX driver's blocks: data (``metadata``; for s1
``semantic``, ``wav_dir`` (the ``.bert.npy`` sidecars), ``max_sec``; for
s2 ``wav_dir``, ``sampling_rate``, ``filter_length``, ``hop_length``,
``win_length``), model (ARConfig or SoVITSConfig overrides) and train
(batch_size 8, seed 1234, epochs, log_interval, save_interval; for s1
``if_dpo``, which halves the batch, ``learning_rate``, ``warmup_steps``,
``total_steps``, ``weight_decay`` and ``grad_clip``, for ScaledAdam as in
the JAX driver; for s2 the GAN's learning rate, betas, eps, ``c_mel``,
``c_kl``, ``c_commit``, ``n_mel_channels`` 128 and ``mel_fmax``). Stage 2
sets no learning-rate schedule, as the JAX driver does not. Every
``save_interval`` steps, and at the end, the driver writes
``STATE_{step}.pt`` (the whole state: parameters, optimizer states, the
codebook's EMA buffers) and the trained tree in the bundle layout,
``AR_{step}.npz`` (s1) or ``SOVITS_{step}.npz`` (s2, its codebook the
EMA's); a later run with the same model directory resumes from the newest
``STATE``. It runs on the card unless ``--device cpu`` is given, and raises
without CUDA. Under torchrun's environment (or with run_vits2's ``--dist-*``
flags) every process joins the group and takes its rows of the global batch
(the config's ``batch_size`` x the ranks), as run_vits2 does; each rank
collates its own rows.
"""

from __future__ import annotations

import argparse
import json
import logging

import torch

from ..models.gpt_sovits import ARConfig, SoVITSConfig
from ..parallel import mesh as M
from ..utils import checkpoint as ckpt
from ..utils import params as P
from ..utils.precision import full_float32
from . import gpt_sovits_train as T
from .driver_common import (add_distributed_args, host_shard, join, log, rank_seed,
                            resume_state, save_state, train_loop)
from .gpt_sovits_data import S1DataConfig, S1Dataset, S2DataConfig, S2Dataset, ShuffleBatcher


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def _fields(cls, d: dict, skip=()) -> dict:
    """The entries of ``d`` that are fields of ``cls``, JSON lists as tuples."""
    return {k: _tuples(v) for k, v in d.items() if k in cls.__dataclass_fields__ and k not in skip}


def build_s1(cfg: dict):
    data, model, train = cfg.get("data", {}), cfg.get("model", {}), cfg.get("train", {})
    dcfg = S1DataConfig(metadata=data["metadata"], semantic=data["semantic"],
                        wav_dir=data.get("wav_dir", ""), bert_dim=model.get("bert_dim", 1024),
                        max_sec=data.get("max_sec", 100), pad_val=model.get("eos", 1024))
    mcfg = ARConfig(**_fields(ARConfig, model))
    tcfg = T.S1TrainConfig(
        learning_rate=train.get("learning_rate", 1e-4),
        warmup_steps=train.get("warmup_steps", 2000),
        total_steps=train.get("total_steps", 300_000),
        weight_decay=train.get("weight_decay", 0.01),
        grad_clip=train.get("grad_clip", 1.0),
        if_dpo=train.get("if_dpo", False),
    )
    return dcfg, mcfg, tcfg


def build_s2(cfg: dict):
    data, model, train = cfg.get("data", {}), cfg.get("model", {}), cfg.get("train", {})
    dcfg = S2DataConfig(metadata=data["metadata"], wav_dir=data.get("wav_dir", ""),
                        sampling_rate=data.get("sampling_rate", 32000),
                        filter_length=data.get("filter_length", 2048),
                        hop_length=data.get("hop_length", 640),
                        win_length=data.get("win_length", 2048),
                        ssl_dim=model.get("ssl_dim", 768))
    mcfg = SoVITSConfig(spec_channels=dcfg.filter_length // 2 + 1,
                        **_fields(SoVITSConfig, model, skip=("spec_channels",)))
    tcfg = T.S2TrainConfig(
        learning_rate=train.get("learning_rate", 2e-4),
        betas=tuple(train.get("betas", (0.8, 0.99))),
        eps=train.get("eps", 1e-9),
        lr_decay=train.get("lr_decay", 0.999875),
        c_mel=train.get("c_mel", 45.0),
        c_kl=train.get("c_kl", 1.0),
        c_commit=train.get("c_commit", 1.0),
        sampling_rate=dcfg.sampling_rate,
        filter_length=dcfg.filter_length,
        hop_length=dcfg.hop_length,
        win_length=dcfg.win_length,
        n_mel_channels=train.get("n_mel_channels", 128),
        mel_fmax=train.get("mel_fmax"),
    )
    return dcfg, mcfg, tcfg


def save_s1(model_dir: str, state, epoch: int) -> None:
    save_state(model_dir, state, epoch)
    ckpt.save_train_state(model_dir, "AR", state.step,
                          P.from_port_layout(state.params["ar"].numpy_tree(), P.AR_LINEARS))


def save_s2(model_dir: str, state: T.S2TrainState, epoch: int) -> None:
    save_state(model_dir, state, epoch)
    ckpt.save_train_state(model_dir, "SOVITS", state.step, state.bundle_tree())


def main(argv=None):
    """Train one stage; returns (the state, the last step's metrics as
    floats, empty where no step ran)."""
    full_float32()
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", choices=("s1", "s2"), required=True)
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-m", "--model-dir", required=True)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--max-steps", type=int, default=None,
                    help="stop (and save) once the step count reaches this")
    ap.add_argument("--log-interval", type=int, default=None)
    ap.add_argument("--save-interval-steps", type=int, default=None)
    ap.add_argument("--device", default=None, help="default: the card")
    add_distributed_args(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device, dp, made_group = join(args)

    with open(args.config, encoding="utf-8") as f:
        cfg = json.load(f)
    train_cfg = cfg.get("train", {})
    batch_size = train_cfg.get("batch_size", 8)
    seed = train_cfg.get("seed", 1234)
    if args.stage == "s1":
        dcfg, mcfg, tcfg = build_s1(cfg)
        if tcfg.if_dpo:  # the DPO pass doubles the memory (ar/data/data_module.py:45)
            batch_size = max(batch_size // 2, 1)
        dataset = S1Dataset(dcfg)
        state = T.init_s1_state(mcfg, tcfg, seed=seed, device=device)
        step_fn, save = T.make_s1_step(mcfg, tcfg, dp=dp), save_s1
    else:
        dcfg, mcfg, tcfg = build_s2(cfg)
        dataset = S2Dataset(dcfg)
        state = T.init_s2_state(mcfg, tcfg, seed=seed, device=device)
        step_fn, save = T.make_s2_step(mcfg, tcfg, dp=dp), save_s2
    batcher = ShuffleBatcher(dataset, batch_size, **host_shard(dp))
    log.info("stage %s: %d rows, %d batches an epoch", args.stage, len(dataset),
             batcher.num_batches())

    start_epoch = resume_state(args.model_dir, state, dp)
    metrics = train_loop(model_dir=args.model_dir, state=state, step_fn=step_fn, batcher=batcher,
                         epochs=args.epochs or train_cfg.get("epochs", 100), device=device,
                         start_epoch=start_epoch or 0,
                         log_interval=args.log_interval or train_cfg.get("log_interval", 100),
                         save_interval=(args.save_interval_steps
                                        or train_cfg.get("save_interval", 1000)),
                         max_steps=args.max_steps, save=save,
                         generator=torch.Generator(device=device).manual_seed(rank_seed(seed, dp)))
    if made_group:
        M.shutdown()
    return state, metrics


if __name__ == "__main__":
    main()
