"""VITS2 training driver (vosk_tts_tpu/train/run_vits2.py), on the card.

Usage:
  python -m vosk_tts_tpu_torch.train.run_vits2 -c config.json -m MODEL_DIR \
      [--finetune PRETRAINED_DIR] [--wavlm-dir WAVLM_DIR] [--epochs N] \
      [--max-steps N] [--device cpu]
  torchrun --nproc-per-node N -m vosk_tts_tpu_torch.train.run_vits2 -c config.json -m DIR
  python -m vosk_tts_tpu_torch.train.run_vits2 ... --dist-coordinator HOST:PORT \
      --dist-num-processes N --dist-process-id I

``config.json`` follows the reference schema the JAX package reads
(training/vits2/configs/mb_istft_vits2_multi.json: train, data and model
blocks), for every flow type, duration predictor and decoder; the port
also reads the model block's ``istft_mode`` ("torch", the default, or
"onnx"), which the JAX reader leaves at "torch". Each step runs D ->
(WavLM D) -> durD -> G (train/vits2_train.py). Every ``eval_interval``
steps, and at the end, the driver writes ``STATE_{step}.pt`` (the whole
state, for resume) and ``G_{step}.npz`` (the generator in the bundle
layout, loadable by both packages); a later run with the same model
directory resumes from the newest STATE, and warns where the code's git
commit differs from the one the first run wrote to ``githash``.
``--finetune DIR`` starts G, D and durD from DIR's newest STATE (a WavLM
discriminator starts fresh, as in the JAX driver) and keeps the duration
discriminator's parameters frozen (restored after every step, while its
optimizer state advances, as the JAX driver does). ``--wavlm-dir DIR``
turns on the WavLM/SLM loss: a frozen WavLM from ``DIR/config.json`` (a
Hugging Face ``WavLMConfig`` dict) and ``DIR/params.npz`` (the bundle
layout), and a WavLM discriminator with its own AdamW over its
``num_hidden_layers + 1`` states (the train block's ``slm_initial``
channels, default 64). It runs on the card unless ``--device cpu`` is given
and raises without CUDA.

Data-parallel training (the JAX driver's ``--distributed``,
``--dist-coordinator``, ``--dist-num-processes``, ``--dist-process-id``;
under torchrun's environment the driver joins by itself): one process a
card (``cuda:LOCAL_RANK``, NCCL; gloo where torchrun's LOCAL_WORLD_SIZE
exceeds the cards, and for CPU ranks with ``--device cpu``), each with its
rows of the global batch, which is the config's ``batch_size`` x the
ranks; each step is the global batch's step (train/vits2_train.py). Each
rank draws its rows' noise from its own generator, seeded by the seed +
its rank. Rank 0 logs and writes the checkpoints.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os

import torch

from ..models.vits2 import VITS2Config
from ..models.wavlm import WavLM, WavLMConfig
from ..parallel import mesh as M
from ..utils import checkpoint as ckpt
from ..utils.params import LINEARS, from_port_layout, to_port_layout
from ..utils.repro import check_git_hash
from ..utils.precision import full_float32
from . import vits2_train as T
from .data import BucketBatcher, DataConfig, TTSDataset
from .driver_common import (add_distributed_args, host_shard, is_main, join, log,
                            rank_seed, resume_state, save_state, train_loop)


def build_configs(cfg: dict):
    train, data, model = cfg["train"], cfg["data"], cfg["model"]
    mcfg = VITS2Config.from_reference_json(model, data, train)
    tcfg = T.TrainConfig(
        learning_rate=train.get("learning_rate", 2e-4),
        betas=tuple(train.get("betas", (0.8, 0.99))),
        eps=train.get("eps", 1e-9),
        lr_decay=train.get("lr_decay", 0.999875),
        c_mel=train.get("c_mel", 45.0),
        c_kl=train.get("c_kl", 1.0),
        sampling_rate=data.get("sampling_rate", 22050),
        filter_length=data.get("filter_length", 1024),
        hop_length=data.get("hop_length", 256),
        win_length=data.get("win_length", 1024),
        n_mel_channels=data.get("n_mel_channels", 80),
        mel_fmin=data.get("mel_fmin", 0.0),
        mel_fmax=data.get("mel_fmax"),
        fft_sizes=tuple(train.get("fft_sizes", (384, 683, 171))),
        hop_sizes=tuple(train.get("hop_sizes", (30, 60, 10))),
        win_lengths=tuple(train.get("win_lengths", (150, 300, 60))),
        use_dur_disc=model.get("use_duration_discriminator", True),
    )
    dcfg = DataConfig(
        metadata=data["training_files"],
        sampling_rate=tcfg.sampling_rate,
        filter_length=tcfg.filter_length,
        hop_length=tcfg.hop_length,
        win_length=tcfg.win_length,
        n_mel_channels=tcfg.n_mel_channels,
        mel_fmin=tcfg.mel_fmin,
        mel_fmax=tcfg.mel_fmax,
        add_blank=data.get("add_blank", True),
        text_mode="aligned" if data.get("aligned_text") else ("g2p" if data.get("g2p_text") else "aligned"),
    )
    return mcfg, tcfg, dcfg


def load_wavlm(wavlm_dir: str, device) -> WavLM:
    """The frozen WavLM of ``wavlm_dir``: ``config.json`` (Hugging Face
    ``WavLMConfig`` keys) and ``params.npz`` (the bundle layout)."""
    with open(os.path.join(wavlm_dir, "config.json"), encoding="utf-8") as f:
        cfg = WavLMConfig.from_hf(json.load(f))
    tree = to_port_layout(ckpt.load_params(os.path.join(wavlm_dir, "params.npz")))
    return WavLM(cfg, tree).to(device)


def save(model_dir: str, state: T.TrainState, epoch: int) -> None:
    save_state(model_dir, state, epoch)
    ckpt.save_train_state(model_dir, "G", state.step,
                          from_port_layout(state.params["g"].numpy_tree(), LINEARS))


def main(argv=None):
    """Train; returns (the TrainState, the last step's metrics as floats,
    empty where no step ran)."""
    full_float32()
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-m", "--model-dir", required=True)
    ap.add_argument("--finetune", default=None, help="pretrained model directory (its STATE_*)")
    ap.add_argument("--wavlm-dir", default=None,
                    help="a WavLM (config.json, params.npz): turns on the SLM loss")
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
    if is_main():
        check_git_hash(args.model_dir)

    with open(args.config, encoding="utf-8") as f:
        cfg = json.load(f)
    mcfg, tcfg, dcfg = build_configs(cfg)
    train_cfg = cfg["train"]
    epochs = args.epochs or train_cfg.get("epochs", 20000)
    log_interval = args.log_interval or train_cfg.get("log_interval", 200)
    save_interval = args.save_interval_steps or train_cfg.get("eval_interval", 1000)
    # the config's batch is a rank's: the global batch is it x the ranks
    batcher = BucketBatcher(TTSDataset(dcfg), train_cfg.get("batch_size", 24), **host_shard(dp))
    log.info("dataset: %d utterances, %d batches an epoch", len(batcher.ds), batcher.num_batches())

    slm, slm_dims = None, {}
    if args.wavlm_dir:
        slm = load_wavlm(args.wavlm_dir, device)
        tcfg = dataclasses.replace(tcfg, use_slm=True)
        slm_dims = {"slm_hidden": slm.cfg.hidden_size,
                    "slm_layers": slm.cfg.num_hidden_layers + 1,
                    "slm_initial": train_cfg.get("slm_initial", 64)}
        log.info("SLM loss on (WavLM from %s)", args.wavlm_dir)

    seed = train_cfg.get("seed", 1234)
    state = T.init_train_state(mcfg, tcfg, seed=seed, device=device, **slm_dims)
    start_epoch = resume_state(args.model_dir, state, dp)
    if start_epoch is None and args.finetune:
        pre = ckpt.load_full_state(args.finetune, "STATE", map_location=device)
        if pre is None:
            raise FileNotFoundError(f"no pretrained STATE_* in {args.finetune}")
        # G, D and durD, as the JAX driver copies them; a WavLM discriminator starts fresh
        for k in ("g", "d", "dur"):
            if k in state.params and f"params_{k}" in pre:
                state.params[k].load_state_dict(pre[f"params_{k}"])
        log.info("finetuning from %s", args.finetune)

    after_step = None
    if args.finetune and "dur" in state.params:
        frozen = {k: v.detach().clone() for k, v in state.params["dur"].state_dict().items()}
        after_step = lambda st: st.params["dur"].load_state_dict(frozen)
    metrics = train_loop(model_dir=args.model_dir, state=state,
                         step_fn=T.make_train_step(mcfg, tcfg, slm=slm, dp=dp), batcher=batcher,
                         epochs=epochs, device=device, start_epoch=start_epoch or 0, log_interval=log_interval,
                         save_interval=save_interval, max_steps=args.max_steps,
                         generator=torch.Generator(device=device).manual_seed(rank_seed(seed, dp)),
                         save=save,
                         set_lr=lambda st, epoch: T.set_lr(st, T.lr_at_epoch(tcfg, epoch)),
                         after_step=after_step)
    if made_group:
        M.shutdown()
    return state, metrics


if __name__ == "__main__":
    main()
