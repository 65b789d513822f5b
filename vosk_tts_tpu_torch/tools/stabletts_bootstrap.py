"""StableTTS data bootstrap (tools/stabletts_bootstrap.py of the JAX package:
the Matcha utilities a corpus needs before training):

  stats      the dataset's mel mean and std, the normalisation constants of
             the data block's ``mel_mean``/``mel_std``
             (matcha/utils/generate_data_statistics.py:25-47): over the
             un-normalised log-mels, mean = sum / (frames * channels), std
             = sqrt(E[x^2] - mean^2);
  durations  per-phone durations from a trained checkpoint (the newest
             ``STATE_*.pt`` of ``train/run_stabletts``) by monotonic
             alignment search, written as kaldi-style ``.lab`` files beside
             each wav (lines ``phone start dur``; ``parse_lab`` reads the
             last field) (matcha/utils/get_durations_from_trained_model_new.py
             :48-81): the MAS path through the Gaussian log-prior
             N(mel ; mu_mel, I) of the trained text encoder; durations are
             the path's frames a phone.

Usage:
  python -m vosk_tts_tpu_torch.tools.stabletts_bootstrap stats -c config.json [-o stats.json] \
      [--device cpu]
  python -m vosk_tts_tpu_torch.tools.stabletts_bootstrap durations -c config.json -m MODEL_DIR \
      [--batch-size 8] [--bert-dir BERT_BUNDLE] [--device cpu]

``config.json`` is ``train/run_stabletts``'s. ``--bert-dir`` gives the
text encoder the BERT rows the model was trained with
(``run_stabletts --bert-dir``); without it they are zeros. The mels, the
text encoder (the global RoPE attention kernel, 2 x 4 launches a batch)
and MAS (the port's kernel, one launch a batch) run on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np
import torch


def compute_stats(cfg_json: dict, device) -> dict:
    """Mel mean and std over the dataset's raw (un-normalised) log-mels."""
    from ..ops.stft import mel_spectrogram
    from ..train.data import MAX_WAV_VALUE, load_wav
    from ..train.run_stabletts import build_configs

    dcfg, _, _ = build_configs(cfg_json)
    total, total_sq, frames = 0.0, 0.0, 0
    with open(dcfg.metadata, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("|")
            if len(parts) < 3:
                continue
            wav_path = os.path.join(dcfg.wav_dir, parts[0]) if dcfg.wav_dir else parts[0]
            if not wav_path.endswith(".wav"):
                wav_path += ".wav"
            data, sr = load_wav(wav_path)
            if sr != dcfg.sampling_rate:
                raise ValueError(f"{wav_path}: {sr} != {dcfg.sampling_rate}")
            with torch.inference_mode():
                mel = mel_spectrogram(torch.from_numpy(data / MAX_WAV_VALUE).to(device)[None],
                                      dcfg.n_fft, dcfg.n_mels, dcfg.sampling_rate,
                                      dcfg.hop_length, dcfg.win_length, dcfg.f_min,
                                      dcfg.f_max)[0].cpu().numpy()
            total += float(mel.sum())
            total_sq += float((mel.astype(np.float64) ** 2).sum())
            frames += mel.shape[0]
    n = frames * dcfg.n_mels
    mean = total / n
    return {"mel_mean": mean, "mel_std": math.sqrt(total_sq / n - mean * mean)}


def mel_log_prior(params, mcfg, batch):
    """The trained text encoder's Gaussian log-prior log N(y ; mu_mel, I),
    scored per (frame, phone): (B, T_f, T_x), and the (frame, phone) mask.
    ``batch``: x (B, 5, T_x), x_lengths, mel (B, T_f, n_feats) normalised,
    mel_lengths, sid, bert (B, T_x, bert_dim); tensors on the tree's
    device."""
    from ..models import stabletts as S
    from ..ops.commons import sequence_mask

    y = batch["mel"]
    sid = batch["sid"].long()
    _, mu_mel, _, x_mask = S.text_encoder_apply(params["text_encoder"], mcfg, batch["x"],
                                                batch["x_lengths"], params["spk_emb"][sid],
                                                params["dur_spk_emb"][sid], batch["bert"])
    y_mask = sequence_mask(batch["mel_lengths"], y.shape[1]).to(x_mask.dtype)
    const = -0.5 * mcfg.n_feats * math.log(2 * math.pi)
    yy = -0.5 * y.square().sum(dim=-1)                      # (B, T_f)
    cross = torch.einsum("byc,btc->byt", y, mu_mel)         # (B, T_f, T_x)
    mm = -0.5 * mu_mel.square().sum(dim=-1)                 # (B, T_x)
    log_prior = yy[:, :, None] + cross + mm[:, None, :] + const
    return log_prior, y_mask[:, :, None] * x_mask[..., 0][:, None, :]


def mas_durations(params, mcfg, batch) -> torch.Tensor:
    """The MAS path's durations (B, T_x) int32 through :func:`mel_log_prior`
    (matcha_tts.py's forward MAS; ops/mas.maximum_path)."""
    from ..ops.mas import maximum_path

    return maximum_path(*mel_log_prior(params, mcfg, batch)).sum(dim=1).to(torch.int32)


def write_lab(path: str, phones, durs) -> None:
    """Kaldi-style label file: ``phone start dur`` a line (README "Label
    file example"; ``stabletts_data.parse_lab`` reads the last field)."""
    lines, start = [], 0
    for p, d in zip(phones, durs):
        lines.append(f"{int(p)} {start} {int(d)}")
        start += int(d)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


def load_tree(model_dir: str, mcfg, device):
    """The Matcha tree (port layout, tensors on ``device``) of the newest
    ``STATE_*.pt`` of ``model_dir``."""
    from ..models.tree import TreeModule
    from ..train.stabletts_train import init_tree
    from ..utils.checkpoint import load_full_state

    saved = load_full_state(model_dir, "STATE", map_location=device)
    if saved is None:
        raise FileNotFoundError(f"no STATE_* checkpoint in {model_dir}")
    net = TreeModule(init_tree(mcfg, seed=0)).to(device)
    net.load_state_dict(saved["params_g"])
    return net.params


def run_durations(cfg_json: dict, model_dir: str, batch_size: int = 8, bert_fn=None, *,
                  device) -> int:
    """Write a ``.lab`` beside every wav of the corpus; returns how many."""
    from ..train.driver_common import to_device
    from ..train.run_stabletts import build_configs
    from ..train.stabletts_data import StableBatcher, StableTTSDataset

    dcfg, mcfg, _ = build_configs(cfg_json)
    dcfg.load_durations = False  # that is what this run makes
    ds = StableTTSDataset(dcfg, bert_fn=bert_fn)
    batcher = StableBatcher(ds, batch_size)
    params = load_tree(model_dir, mcfg, device)
    written = 0
    # every item once, in the batcher's length order, one padded batch at a time
    order = list(batcher.order)
    for j in range(0, len(order), batch_size):
        idxs = order[j: j + batch_size]
        batch = batcher.collate(idxs)
        with torch.inference_mode():
            durs = mas_durations(params, mcfg, to_device(
                {k: v for k, v in batch.items() if k != "durations"}, device)).cpu().numpy()
        for row, i in enumerate(idxs):
            t, nf = int(batch["x_lengths"][row]), int(batch["mel_lengths"][row])
            d = durs[row, :t]
            if d.sum() != nf:  # MAS covers every frame
                raise RuntimeError(f"{ds.items[i][0]}: durations sum to {d.sum()}, not {nf} frames")
            write_lab(ds.items[i][0][:-4] + ".lab", batch["x"][row, 0, :t], d)
            written += 1
    return written


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("stats")
    ps.add_argument("-c", "--config", required=True)
    ps.add_argument("-o", "--output", default=None)
    ps.add_argument("--device", default=None, help="default: the card")
    pd = sub.add_parser("durations")
    pd.add_argument("-c", "--config", required=True)
    pd.add_argument("-m", "--model-dir", required=True)
    pd.add_argument("--batch-size", type=int, default=8)
    pd.add_argument("--bert-dir", default=None, help="a BERT bundle: config.json, params.npz, "
                                                     "vocab.txt")
    pd.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    from ..api import resolve_device

    device = resolve_device(args.device)
    with open(args.config, encoding="utf-8") as f:
        cfg_json = json.load(f)
    if args.cmd == "stats":
        stats = compute_stats(cfg_json, device)
        out = json.dumps(stats, indent=1)
        if args.output:
            with open(args.output, "w", encoding="utf-8") as f:
                f.write(out + "\n")
        print(out)
        return stats
    from ..train.run_stabletts import make_bert_fn

    bert_fn = make_bert_fn(args.bert_dir, device) if args.bert_dir else None
    n = run_durations(cfg_json, args.model_dir, args.batch_size, bert_fn, device=device)
    print(f"wrote {n} .lab files")
    return n


if __name__ == "__main__":
    main()
