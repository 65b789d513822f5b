"""Neural letter-to-sound model for English OOV words: the numpy greedy
decoder of the trained artifact ``g2p_en_lstm.npz``, and the training
forward (vosk_tts_tpu/text/neural_g2p.py).

The model is g2p_en's family (an LSTM-attention seq2seq trained on
CMUdict): a character embedding and a single-layer BiLSTM encoder; a phone
embedding and an LSTM decoder with dot-product attention over the encoder
states, greedy at inference. The inference class is numpy (one word at a
time on the host, where the text frontend runs); :func:`init_params`,
:func:`encoder_apply` and :func:`teacher_logits` are its torch training
forward (tools/train_g2p.py), the LSTMs unrolled a step at a time over the
full padded window as the JAX package's ``lax.scan`` runs them, and
:func:`flatten_for_npz` writes the artifact the class reads.
"""

from __future__ import annotations

import numpy as np
import torch

# letters a-z plus apostrophe; 0 = PAD
LETTERS = "abcdefghijklmnopqrstuvwxyz'"
L2I = {c: i + 1 for i, c in enumerate(LETTERS)}
MAX_WORD = 20
MAX_PHONES = 24  # incl. EOS


def phone_vocab():
    """Stressed-ARPA output alphabet: PAD, BOS, EOS + CMU phones."""
    from .en_g2p import arpa_symbols

    return ["<pad>", "<bos>", "<eos>"] + sorted(arpa_symbols())


def encode_word(word: str) -> np.ndarray:
    ids = [L2I[c] for c in word if c in L2I][:MAX_WORD]
    out = np.zeros((MAX_WORD,), np.int32)
    out[: len(ids)] = ids
    return out


# ---------------------------------------------------------------------------
# training forward (torch)
# ---------------------------------------------------------------------------


def init_params(generator: torch.Generator, *, emb: int = 128, enc_hidden: int = 128,
                dec_hidden: int = 256, n_phones: int = 90) -> dict:
    """The tree the trainer updates, on ``generator``'s device: matrices
    N(0, 1/fan_in), LSTM biases and ``out_b`` zero (the JAX package's
    ``init_params``; its jax.random draws are other numbers)."""
    dev = generator.device
    mat = lambda a, b: torch.randn((a, b), generator=generator, device=dev) * a**-0.5
    lstm = lambda i, h: {"w_ih": mat(i, 4 * h), "b_ih": torch.zeros(4 * h, device=dev),
                         "w_hh": mat(h, 4 * h), "b_hh": torch.zeros(4 * h, device=dev)}
    enc_out = 2 * enc_hidden
    return {
        "char_emb": mat(len(LETTERS) + 1, emb),
        "enc_f": lstm(emb, enc_hidden),
        "enc_b": lstm(emb, enc_hidden),
        "phone_emb": mat(n_phones, emb),
        "dec": lstm(emb + enc_out, dec_hidden),
        "attn_q": mat(dec_hidden, enc_out),
        "out": mat(dec_hidden + enc_out, n_phones),
        "out_b": torch.zeros(n_phones, device=dev),
        "dec_h0": mat(enc_out, dec_hidden),
    }


def _lstm_cell(layer, x, h, c):
    g = x @ layer["w_ih"] + layer["b_ih"] + h @ layer["w_hh"] + layer["b_hh"]
    i, f, gg, o = g.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(c), c


def _lstm_seq(layer, x, reverse=False):
    """x (B, T, I) -> hidden states (B, T, H), over every step of the window."""
    b, t, _ = x.shape
    h = c = x.new_zeros((b, layer["w_hh"].shape[0]))
    out = [None] * t
    for step in (range(t - 1, -1, -1) if reverse else range(t)):
        h, c = _lstm_cell(layer, x[:, step], h, c)
        out[step] = h
    return torch.stack(out, dim=1)


def encoder_apply(params, word_ids: torch.Tensor):
    """word_ids (B, MAX_WORD) -> (states (B, T, 2H) zero at padding, mask (B, T))."""
    x = params["char_emb"][word_ids.long()]
    enc = torch.cat([_lstm_seq(params["enc_f"], x), _lstm_seq(params["enc_b"], x, reverse=True)],
                    dim=-1)
    mask = (word_ids > 0).to(enc.dtype)
    return enc * mask[..., None], mask


def teacher_logits(params, word_ids: torch.Tensor, phone_in: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder logits (B, Tp, V); phone_in (B, Tp) the
    BOS-led targets. The decoder starts from the mean valid encoder state."""
    enc, mask = encoder_apply(params, word_ids)
    dec = params["dec"]
    h = torch.tanh((enc.sum(dim=1) / mask.sum(dim=1, keepdim=True).clamp(min=1)) @ params["dec_h0"])
    c = enc.new_zeros((enc.shape[0], dec["w_hh"].shape[0]))
    ctx = enc.new_zeros((enc.shape[0], enc.shape[-1]))
    emb = params["phone_emb"][phone_in.long()]
    neg = (1.0 - mask) * -1e9
    logits = []
    for step in range(emb.shape[1]):
        h, c = _lstm_cell(dec, torch.cat([emb[:, step], ctx], dim=-1), h, c)
        score = torch.einsum("bd,btd->bt", h @ params["attn_q"], enc) + neg
        ctx = torch.einsum("bt,btd->bd", torch.softmax(score, dim=-1), enc)
        logits.append(torch.cat([h, ctx], dim=-1) @ params["out"] + params["out_b"])
    return torch.stack(logits, dim=1)


def flatten_for_npz(params, phones) -> dict:
    """The trainer's tree (tensors or arrays) -> the npz layout
    :class:`NeuralG2P` reads."""
    flat = {k: params[k] for k in ("char_emb", "phone_emb", "attn_q", "out", "out_b", "dec_h0")}
    for name in ("enc_f", "enc_b", "dec"):
        for k in ("w_ih", "b_ih", "w_hh", "b_hh"):
            flat[f"{name}_{k}"] = params[name][k]
    flat = {k: np.asarray(torch.as_tensor(v).detach().cpu(), np.float32) for k, v in flat.items()}
    flat["phones"] = np.asarray(phones)
    return flat


def _sig(x):
    return 1.0 / (1.0 + np.exp(-x))


class NeuralG2P:
    """Greedy numpy decoder around a trained artifact."""

    def __init__(self, npz_path):
        z = np.load(npz_path, allow_pickle=True)
        self.p = {k: z[k].astype(np.float32) for k in z.files if k != "phones"}
        self.phones = [str(s) for s in z["phones"]]

    def _lstm_seq(self, pre, x, reverse=False):
        w_ih, b_ih = self.p[pre + "_w_ih"], self.p[pre + "_b_ih"]
        w_hh, b_hh = self.p[pre + "_w_hh"], self.p[pre + "_b_hh"]
        hid = w_hh.shape[0]
        t = x.shape[0]
        h = np.zeros(hid, np.float32)
        c = np.zeros(hid, np.float32)
        out = np.zeros((t, hid), np.float32)
        order = range(t - 1, -1, -1) if reverse else range(t)
        for idx in order:
            g = x[idx] @ w_ih + b_ih + h @ w_hh + b_hh
            i, f, gg, o = np.split(g, 4)
            c = _sig(f) * c + _sig(i) * np.tanh(gg)
            h = _sig(o) * np.tanh(c)
            out[idx] = h
        return out

    def predict(self, word: str) -> list:
        ids = [L2I[ch] for ch in word.lower() if ch in L2I][:MAX_WORD]
        if not ids:
            return []
        # replicate training exactly: the LSTMs run over the FULL padded
        # window (the backward scan consumes the pad rows first and the
        # model was trained with that), then only real rows feed attention
        padded = np.zeros((MAX_WORD,), np.int64)
        padded[: len(ids)] = ids
        x = self.p["char_emb"][padded]
        hf = self._lstm_seq("enc_f", x)
        hb = self._lstm_seq("enc_b", x, reverse=True)
        enc = np.concatenate([hf, hb], axis=-1)[: len(ids)]  # (T, 2H)

        w_ih, b_ih = self.p["dec_w_ih"], self.p["dec_b_ih"]
        w_hh, b_hh = self.p["dec_w_hh"], self.p["dec_b_hh"]
        hid = w_hh.shape[0]
        h = np.tanh(enc.mean(axis=0) @ self.p["dec_h0"])
        c = np.zeros(hid, np.float32)
        ctx = np.zeros(enc.shape[-1], np.float32)
        tok = 1  # BOS
        out = []
        for _ in range(MAX_PHONES):
            inp = np.concatenate([self.p["phone_emb"][tok], ctx])
            g = inp @ w_ih + b_ih + h @ w_hh + b_hh
            i, f, gg, o = np.split(g, 4)
            c = _sig(f) * c + _sig(i) * np.tanh(gg)
            h = _sig(o) * np.tanh(c)
            q = h @ self.p["attn_q"]
            score = enc @ q
            score = score - score.max()
            a = np.exp(score)
            a /= a.sum()
            ctx = a @ enc
            logit = np.concatenate([h, ctx]) @ self.p["out"] + self.p["out_b"]
            tok = int(np.argmax(logit))
            if tok == 2:  # EOS
                break
            if tok > 2:
                out.append(self.phones[tok])
        return out
