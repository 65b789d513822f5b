"""Train the neural English G2P (text/neural_g2p.py) on a CMUdict
(tools/train_g2p.py of the JAX package).

The held-out eval words (``random.seed(0)`` samples of the [a-z]{4,12}
vocabulary: 400 and 3000 words, the protocol of tests/test_cleaner.py and
``lts_error_analysis``) are left out of training, so that the artifact's
reported PER is honest. Model selection uses a separate 2000-word dev
split of the training rows; the held-out PER is reported once, at the end.

Usage:
  python -m vosk_tts_tpu_torch.tools.train_g2p --dict-dir DIR [--epochs 24] [--batch 256] \
      [--lr 2e-3] [--out vosk_tts_tpu_torch/text/g2p_en_lstm.npz] [--device cpu]

``DIR`` holds ``cmudict.rep`` (the reference's training/gpt-sovits/text).
:func:`train` is the loop: masked NLL of the teacher-forced logits, the
gradient clipped to a global norm of 1, then Adam under a cosine decay of
the learning rate over every step of the run (optax's
``chain(clip_by_global_norm(1.0), adam(cosine_decay_schedule(lr, steps)))``).
Training runs on the card unless ``--device cpu`` is given.
"""

import argparse
import math
import os
import random
import re
import time

import numpy as np
import torch

from ..text import neural_g2p as NG


def read_cmu(path) -> dict:
    """``cmudict.rep`` of ``path`` -> {word: phones}: lines from the 57th,
    the first reading of each word, words of letters and apostrophes."""
    cmu = {}
    with open(os.path.join(path, "cmudict.rep"), encoding="latin-1") as f:
        for i, line in enumerate(f):
            if i < 57 or not line.strip():
                continue
            parts = line.strip().split("  ")
            if len(parts) != 2:
                continue
            w = parts[0].lower()
            if not re.fullmatch(r"[a-z']+", w):
                continue
            cmu.setdefault(w, tuple(parts[1].split(" ")))
    return cmu


def edit(a, b) -> int:
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def held_out(cmu: dict):
    """The 400- and 3000-word held-out samples of the eval protocol."""
    vocab = [w for w in cmu if re.fullmatch(r"[a-z]{4,12}", w)]
    random.seed(0)
    held400 = set(random.sample(vocab, 400))
    random.seed(0)
    return held400, random.sample(vocab, 3000)


def pack(items, phones):
    """[(word, phones)] -> (word ids, BOS-led phone inputs, EOS-ended targets), int32."""
    p2i = {p: i for i, p in enumerate(phones)}
    n = len(items)
    wid = np.zeros((n, NG.MAX_WORD), np.int32)
    pin = np.zeros((n, NG.MAX_PHONES), np.int32)
    tgt = np.zeros((n, NG.MAX_PHONES), np.int32)
    for i, (w, ph) in enumerate(items):
        wid[i] = NG.encode_word(w)
        ids = [p2i[p] for p in ph]
        pin[i, 0] = 1  # BOS
        pin[i, 1: 1 + len(ids)] = ids
        tgt[i, : len(ids)] = ids
        tgt[i, len(ids)] = 2  # EOS
    return wid, pin, tgt


def loss_fn(params, wid, pin, tgt):
    """Mean NLL over the target positions up to and with EOS (PAD after it
    is masked)."""
    logits = NG.teacher_logits(params, wid, pin)
    mask = ((tgt > 0) | (tgt == 2)).to(logits.dtype)
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, tgt.long()[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1)


def cosine_decay(lr: float, steps: int, count: int) -> float:
    """optax.cosine_decay_schedule(lr, steps) at ``count`` (alpha 0)."""
    return lr * 0.5 * (1 + math.cos(math.pi * min(count, steps) / steps))


def train(rows, phones, *, epochs: int, batch: int, lr: float, device,
          generator: torch.Generator):
    """Yields ``(epoch, params, losses)`` after each epoch: the tree (leaves
    on ``device``, updated in place) and that epoch's step losses (floats).
    ``rows``: [(word, phones)]; ``generator`` (CPU) draws the init
    (:func:`neural_g2p.init_params`) and then each epoch's order of the
    rows, full batches only."""
    wid, pin, tgt = (torch.from_numpy(a).to(device) for a in pack(rows, phones))
    leaf = lambda t: t.to(device).requires_grad_(True)
    params = {k: {n: leaf(t) for n, t in v.items()} if isinstance(v, dict) else leaf(v)
              for k, v in NG.init_params(generator, n_phones=len(phones)).items()}
    leaves = [t for v in params.values() for t in (v.values() if isinstance(v, dict) else [v])]
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    nb = len(rows) // batch
    steps, count = epochs * nb, 0
    for epoch in range(epochs):
        order = torch.randperm(len(rows), generator=generator).to(device)
        losses = []
        for j in range(nb):
            idx = order[j * batch: (j + 1) * batch]
            loss = loss_fn(params, wid[idx], pin[idx], tgt[idx])
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                             for g in grads]))
                scale = torch.where(norm < 1.0, 1.0, 1.0 / norm)  # optax clip_by_global_norm(1)
                for t, g in zip(leaves, grads):
                    t.grad = g * scale
            for group in opt.param_groups:
                group["lr"] = cosine_decay(lr, steps, count)
            opt.step()
            count += 1
            losses.append(loss.detach())
        yield epoch, params, torch.stack(losses).cpu().tolist() if losses else []


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dict-dir", required=True, help="the directory of cmudict.rep")
    ap.add_argument("--epochs", type=int, default=24)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--out", default=os.path.join(os.path.dirname(NG.__file__), "g2p_en_lstm.npz"))
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    from ..api import resolve_device

    device = resolve_device(args.device)
    cmu = read_cmu(args.dict_dir)
    held400, held3000 = held_out(cmu)
    held = held400 | set(held3000)
    phones = NG.phone_vocab()
    known = set(phones)
    rows = [(w, ph) for w, ph in cmu.items()
            if w not in held and 2 <= len(w) <= NG.MAX_WORD and len(ph) + 1 <= NG.MAX_PHONES
            and all(p in known for p in ph)]
    random.seed(1)
    random.shuffle(rows)
    dev, train_rows = rows[:2000], rows[2000:]
    print(f"train {len(train_rows)}  dev {len(dev)}  held-out {len(held3000)}")

    def per(model, words):
        strip = lambda ps: [x.rstrip("012") for x in ps]
        e = t = 0
        for w in words:
            gold = list(cmu[w])
            e += edit(strip(model.predict(w)), strip(gold))
            t += len(gold)
        return e / t

    best_dev, t0 = math.inf, time.time()
    tmp_path = args.out + ".tmp.npz"
    for epoch, params, losses in train(train_rows, phones, epochs=args.epochs, batch=args.batch,
                                       lr=args.lr, device=device,
                                       generator=torch.Generator().manual_seed(0)):
        # dev PER through the numpy inference path (what ships)
        np.savez(tmp_path, **NG.flatten_for_npz(params, phones))
        dev_per = per(NG.NeuralG2P(tmp_path), [w for w, _ in dev[:500]])
        mark = ""
        if dev_per < best_dev:
            best_dev = dev_per
            os.replace(tmp_path, args.out)
            mark = "  *saved"
        print(f"epoch {epoch:2d}  loss {float(np.mean(losses)):.4f}  dev PER {dev_per:.4f}"
              f"  ({time.time() - t0:.0f}s){mark}", flush=True)
    if os.path.exists(tmp_path):
        os.remove(tmp_path)
    held_per = per(NG.NeuralG2P(args.out), held3000)
    print(f"\nFINAL held-out PER (3000 words, stress-stripped): {held_per:.4f}")
    print(f"artifact: {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)")
    return held_per


if __name__ == "__main__":
    main()
