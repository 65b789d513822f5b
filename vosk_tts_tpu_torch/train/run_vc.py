"""QuickVC training driver (vosk_tts_tpu/train/run_vc.py), on the card.

Usage:
  python -m vosk_tts_tpu_torch.train.run_vc -c config.json -m MODEL_DIR \
      [--epochs N] [--max-steps N] [--device cpu]

``config.json``'s train, data and model blocks follow vc/configs/
quickvc.json, as the JAX driver reads them. The data is one wav path a
line (``data.training_files``), each with a ``.cv.npy`` sidecar of its
ContentVec features. Each step runs D then G (train/vc_train.py); the
learning rate stays constant (the JAX driver sets no schedule). Every
``eval_interval`` steps, and at the end, the driver writes
``STATE_{step}.pt``; a later run with the same model directory resumes from
the newest. It runs on the card unless ``--device cpu`` is given, and
raises without CUDA. Under torchrun's environment (or with run_vits2's
``--dist-*`` flags) every process joins the group and takes its rows of the
global batch (the config's ``batch_size`` x the ranks), as run_vits2 does.
"""

from __future__ import annotations

import argparse
import json
import logging

import torch

from ..models.quickvc import QuickVCConfig
from ..parallel import mesh as M
from ..utils.precision import full_float32
from . import vc_train as T
from .driver_common import (add_distributed_args, host_shard, join, log, rank_seed,
                            resume_state, train_loop)
from .gpt_sovits_data import ShuffleBatcher
from .vc_data import VCDataConfig, VCDataset


def build_configs(cfg: dict):
    train, data, model = cfg.get("train", {}), cfg.get("data", {}), cfg.get("model", {})
    dcfg = VCDataConfig(
        file_list=data["training_files"],
        sampling_rate=data.get("sampling_rate", 16000),
        filter_length=data.get("filter_length", 1280),
        hop_length=data.get("hop_length", 320),
        win_length=data.get("win_length", 1280),
        n_mel_channels=data.get("n_mel_channels", 80),
        max_speclen=data.get("max_speclen", 512),
    )
    mcfg = QuickVCConfig(
        spec_channels=dcfg.filter_length // 2 + 1,
        n_mel_channels=model.get("n_mel_channels", dcfg.n_mel_channels),
        **{k: v for k, v in model.items() if k in QuickVCConfig.__dataclass_fields__
           and k not in ("spec_channels", "n_mel_channels")},
    )
    tcfg = T.VCTrainConfig(
        learning_rate=train.get("learning_rate", 2e-4),
        betas=tuple(train.get("betas", (0.8, 0.99))),
        eps=train.get("eps", 1e-9),
        lr_decay=train.get("lr_decay", 0.999875),
        c_mel=train.get("c_mel", 45.0),
        c_kl=train.get("c_kl", 1.0),
        sampling_rate=dcfg.sampling_rate,
        filter_length=dcfg.filter_length,
        hop_length=dcfg.hop_length,
        win_length=dcfg.win_length,
        n_mel_channels=dcfg.n_mel_channels,
    )
    return dcfg, mcfg, tcfg


def main(argv=None):
    """Train; returns (the state, the last step's metrics as floats, empty
    where no step ran)."""
    full_float32()
    ap = argparse.ArgumentParser()
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
    dcfg, mcfg, tcfg = build_configs(cfg)
    train_cfg = cfg.get("train", {})
    batcher = ShuffleBatcher(VCDataset(dcfg), train_cfg.get("batch_size", 64), **host_shard(dp))
    log.info("dataset: %d utterances, %d batches an epoch", len(batcher.ds), batcher.num_batches())

    seed = train_cfg.get("seed", 1234)
    state = T.init_train_state(mcfg, tcfg, seed=seed, device=device)
    start_epoch = resume_state(args.model_dir, state, dp)
    metrics = train_loop(model_dir=args.model_dir, state=state,
                         step_fn=T.make_train_step(mcfg, tcfg, dp=dp), batcher=batcher,
                         epochs=args.epochs or train_cfg.get("epochs", 10000), device=device,
                         start_epoch=start_epoch or 0,
                         log_interval=args.log_interval or train_cfg.get("log_interval", 100),
                         save_interval=(args.save_interval_steps
                                        or train_cfg.get("eval_interval", 1000)),
                         max_steps=args.max_steps,
                         generator=torch.Generator(device=device).manual_seed(rank_seed(seed, dp)))
    if made_group:
        M.shutdown()
    return state, metrics


if __name__ == "__main__":
    main()
