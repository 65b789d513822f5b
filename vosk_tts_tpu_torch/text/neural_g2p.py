"""Neural letter-to-sound model for English OOV words: the numpy greedy
decoder of the trained artifact ``g2p_en_lstm.npz``.

The port's own copy of the inference class of
``vosk_tts_tpu/text/neural_g2p.py`` (its JAX training functions are not
copied); behaviour is identical. The model is g2p_en's family (an
LSTM-attention seq2seq trained on CMUdict): a character embedding and a
single-layer BiLSTM encoder; a phone embedding and an LSTM decoder with
dot-product attention over the encoder states, greedy at inference.
"""

from __future__ import annotations

import numpy as np

# letters a-z plus apostrophe; 0 = PAD
LETTERS = "abcdefghijklmnopqrstuvwxyz'"
L2I = {c: i + 1 for i, c in enumerate(LETTERS)}
MAX_WORD = 20
MAX_PHONES = 24  # incl. EOS


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
