"""StableTTS/Matcha CFM training driver (vosk_tts_tpu/train/run_stabletts.py),
on the card.

Usage:
  python -m vosk_tts_tpu_torch.train.run_stabletts -c config.json -m MODEL_DIR \
      [--bert-dir BERT_BUNDLE] [--epochs N] [--max-steps N] [--device cpu]

``config.json`` has the JAX driver's blocks: data (configs/data/ru.yaml's
fields: training_files, wav_dir, n_spks, sample_rate, n_fft, n_feats,
hop_length, win_length, f_min, f_max, mel_mean, mel_std, load_durations),
model (StableTTSConfig overrides) and train (learning_rate, weight_decay,
grad_clip, accumulate, cfg_dropout, epochs, batch_size, log_interval,
save_interval, seed). A step is one micro-batch (train/stabletts_train.py:
the parameters move every ``accumulate`` steps). ``--bert-dir`` is a BERT
bundle directory (config.json, params.npz, vocab.txt) whose word rows feed
the text encoder; without it the rows are zeros. Every ``save_interval``
steps, and at the end, the driver writes ``STATE_{step}.pt``; a later run
with the same model directory resumes from the newest. It runs on the card
unless ``--device cpu`` is given, and raises without CUDA. Under torchrun's
environment (or with run_vits2's ``--dist-*`` flags) every process joins the
group and takes its rows of the global micro-batch (the config's
``batch_size`` x the ranks), as run_vits2 does.
"""

from __future__ import annotations

import argparse
import json
import logging
import re
from pathlib import Path

import numpy as np
import torch

from ..models.bert import BertEncoder
from ..models.stabletts import StableTTSConfig
from ..parallel import mesh as M
from ..text import WordPieceTokenizer
from ..utils.checkpoint import load_params
from ..utils.params import to_port_layout
from ..utils.precision import full_float32
from . import stabletts_train as T
from .driver_common import (add_distributed_args, host_shard, join, log, rank_seed,
                            resume_state, train_loop)
from .stabletts_data import StableBatcher, StableDataConfig, StableTTSDataset

_PUNCT = re.compile('[-,.?!;:"]')
BERT_LAYER = -3  # get_bert_embeddings reads hidden_states[-3]


def build_configs(cfg: dict):
    data, model, train = cfg.get("data", {}), cfg.get("model", {}), cfg.get("train", {})
    dcfg = StableDataConfig(
        metadata=data["training_files"],
        wav_dir=data.get("wav_dir", ""),
        n_spks=data.get("n_spks", 128),
        sampling_rate=data.get("sample_rate", 22050),
        n_fft=data.get("n_fft", 1024),
        n_mels=data.get("n_feats", 80),
        hop_length=data.get("hop_length", 256),
        win_length=data.get("win_length", 1024),
        f_min=data.get("f_min", 0.0),
        f_max=data.get("f_max", 8000.0),
        mel_mean=data.get("mel_mean", -5.806578636169434),
        mel_std=data.get("mel_std", 2.454238176345825),
        load_durations=data.get("load_durations", True),
        bert_dim=model.get("bert_dim", 768),
    )
    mcfg = StableTTSConfig(
        n_spks=dcfg.n_spks, n_feats=dcfg.n_mels, mel_mean=dcfg.mel_mean, mel_std=dcfg.mel_std,
        **{k: v for k, v in model.items() if k in StableTTSConfig.__dataclass_fields__
           and k not in ("n_spks", "n_feats", "mel_mean", "mel_std")},
    )
    tcfg = T.StableTrainConfig(
        learning_rate=train.get("learning_rate", 1e-4),
        weight_decay=train.get("weight_decay", 0.0),
        grad_clip=train.get("grad_clip", 5.0),
        accumulate=train.get("accumulate", 4),
        cfg_dropout=train.get("cfg_dropout", 0.1),
    )
    return dcfg, mcfg, tcfg


def make_bert_fn(bert_dir, device):
    """Word-level BERT rows for the dataset from a BERT bundle directory,
    run on ``device``: the hidden state ``BERT_LAYER`` at the word-initial
    tokens, dropping ``##`` sub-words and punctuation tokens (with [CLS] and
    [SEP]: n_words + 2 rows)."""
    d = Path(bert_dir)
    tok = WordPieceTokenizer(d / "vocab.txt")
    with open(d / "config.json", encoding="utf-8") as f:
        enc = BertEncoder(to_port_layout(load_params(d / "params.npz")), json.load(f)).to(device)

    def bert_fn(text: str) -> np.ndarray:
        e = tok.encode(text.replace("+", ""))
        rows = enc(e.ids, e.attention_mask, e.type_ids)[BERT_LAYER]
        keep = [i for i, t in enumerate(e.tokens) if t[0] != "#" and not _PUNCT.match(t)]
        return rows[keep].float().cpu().numpy()

    return bert_fn


def main(argv=None):
    """Train; returns (the state, the last step's metrics as floats, empty
    where no step ran)."""
    full_float32()
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-m", "--model-dir", required=True)
    ap.add_argument("--bert-dir", default=None, help="a BERT bundle: config.json, params.npz, "
                                                     "vocab.txt")
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
    bert_fn = make_bert_fn(args.bert_dir, device) if args.bert_dir else None
    batcher = StableBatcher(StableTTSDataset(dcfg, bert_fn=bert_fn), train_cfg.get("batch_size", 6),
                            **host_shard(dp))
    log.info("dataset: %d utterances, %d batches an epoch", len(batcher.ds), batcher.num_batches())

    seed = train_cfg.get("seed", 1234)
    state = T.init_train_state(mcfg, tcfg, seed=seed, device=device)
    start_epoch = resume_state(args.model_dir, state, dp)
    metrics = train_loop(model_dir=args.model_dir, state=state,
                         step_fn=T.make_train_step(mcfg, tcfg, dp=dp), batcher=batcher,
                         epochs=args.epochs or train_cfg.get("epochs", 1000), device=device,
                         start_epoch=start_epoch or 0,
                         log_interval=args.log_interval or train_cfg.get("log_interval", 100),
                         save_interval=(args.save_interval_steps
                                        or train_cfg.get("save_interval", 1000)),
                         max_steps=args.max_steps,
                         generator=torch.Generator(device=device).manual_seed(rank_seed(seed, dp)))
    if made_group:
        M.shutdown()
    return state, metrics


if __name__ == "__main__":
    main()
