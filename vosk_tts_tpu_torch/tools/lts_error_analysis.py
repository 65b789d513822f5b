"""Error analysis of the English OOV prediction path
(tools/lts_error_analysis.py of the JAX package).

Runs the held-out CMUdict eval (``--n`` words, the protocol of
tests/test_cleaner.py), aligns predicted and gold phone sequences, and
classifies every edit:

* substitutions split into vowel quality (vowel -> vowel, stress
  stripped), consonant, and vowel <-> consonant;
* stress placement (phones right, primary stress on the wrong syllable),
  not part of PER (PER strips stress) but audible;
* insertions and deletions by phone class;
* PER by terminal 3-letter suffix, to find systematic suffix failures.

Usage:
  python -m vosk_tts_tpu_torch.tools.lts_error_analysis --dict-dir DIR [--n 3000] [--top 25]

``DIR`` holds ``cmudict.rep`` (the reference's training/gpt-sovits/text).
Host code: the predictions are the numpy G2P's.
"""

import argparse
import collections
import random
import re

from .train_g2p import read_cmu
from ..utils.precision import full_float32

VOWELS = {"AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY", "IH",
          "IY", "OW", "OY", "UH", "UW"}


def align(a, b):
    """Levenshtein alignment of predicted ``a`` and gold ``b``: a list of
    (op, pa, pb), op one of eq, sub, ins (predicted extra), del (gold missing)."""
    n, m = len(a), len(b)
    d = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(n + 1):
        d[i][0] = i
    for j in range(m + 1):
        d[0][j] = j
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            d[i][j] = min(d[i - 1][j] + 1, d[i][j - 1] + 1,
                          d[i - 1][j - 1] + (a[i - 1] != b[j - 1]))
    ops = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and d[i][j] == d[i - 1][j - 1] + (a[i - 1] != b[j - 1]):
            ops.append(("sub" if a[i - 1] != b[j - 1] else "eq", a[i - 1], b[j - 1]))
            i, j = i - 1, j - 1
        elif i > 0 and d[i][j] == d[i - 1][j] + 1:
            ops.append(("ins", a[i - 1], None))
            i -= 1
        else:
            ops.append(("del", None, b[j - 1]))
            j -= 1
    return ops[::-1]


def _stress_idx(phones):
    return next((i for i, p in enumerate(phones) if p.endswith("1")), -1)


def analyse(pairs) -> dict:
    """[(word, predicted phones, gold phones)] -> the tables of the report:
    edit categories, substitution pairs, inserted and deleted phones, edits
    and gold phones by suffix, exact words, misplaced stress, the worst words."""
    out = {"cat": collections.Counter(), "sub_pairs": collections.Counter(),
           "ins": collections.Counter(), "del": collections.Counter(),
           "suffix_err": collections.Counter(), "suffix_tot": collections.Counter(),
           "stress_wrong": 0, "exact": 0, "edits": 0, "gold": 0, "worst": []}
    strip = lambda ps: [p.rstrip("012") for p in ps]
    for w, got, gold in pairs:
        gs, ps = strip(gold), strip(got)
        ops = align(ps, gs)
        errs = sum(1 for op, *_ in ops if op != "eq")
        out["edits"] += errs
        out["gold"] += len(gs)
        out["suffix_err"][w[-3:]] += errs
        out["suffix_tot"][w[-3:]] += len(gs)
        if errs == 0:
            out["exact"] += 1
            out["stress_wrong"] += _stress_idx(got) != _stress_idx(gold)
        else:
            out["worst"].append((errs / len(gs), w, " ".join(ps), " ".join(gs)))
        for op, pa, pb in ops:
            if op == "sub":
                va, vb = pa in VOWELS, pb in VOWELS
                out["cat"]["sub_vowel_quality" if va and vb else
                           "sub_consonant" if not va and not vb else "sub_vowel_consonant"] += 1
                out["sub_pairs"][(pa, pb)] += 1
            elif op == "ins":
                out["cat"]["ins_vowel" if pa in VOWELS else "ins_consonant"] += 1
                out["ins"][pa] += 1
            elif op == "del":
                out["cat"]["del_vowel" if pb in VOWELS else "del_consonant"] += 1
                out["del"][pb] += 1
    return out


def report(a: dict, n: int, top: int) -> None:
    print(f"held-out words: {n};  PER (stress-stripped): {a['edits'] / a['gold']:.4f}")
    print(f"exact (phones): {a['exact']} ({a['exact'] / n:.1%});  of those, primary "
          f"stress misplaced: {a['stress_wrong']} ({a['stress_wrong'] / max(a['exact'], 1):.1%})")
    print("\nerror categories (share of all edits):")
    total = sum(a["cat"].values())
    for k, v in a["cat"].most_common():
        print(f"  {k:22s} {v:6d}  {v / total:.1%}")
    print("\ntop substitutions (pred -> gold):")
    for (pa, pb), v in a["sub_pairs"].most_common(top):
        print(f"  {pa:4s}-> {pb:4s} {v:5d}")
    print(f"\ntop insertions (predicted extra): {a['ins'].most_common(10)}")
    print(f"top deletions (gold missing):     {a['del'].most_common(10)}")
    print("\nworst suffix classes (>=30 gold phones):")
    rows = [(a["suffix_err"][s] / t, s, a["suffix_err"][s], t)
            for s, t in a["suffix_tot"].items() if t >= 30]
    for r, s, e, t in sorted(rows, reverse=True)[:top]:
        print(f"  -{s:4s} PER {r:.3f}  ({e}/{t})")
    print("\nworst words:")
    for r, w, p, gd in sorted(a["worst"], reverse=True)[:15]:
        print(f"  {w:14s} {r:.2f}  pred: {p}")
        print(f"  {'':14s}       gold: {gd}")


def main(argv=None):
    full_float32()
    ap = argparse.ArgumentParser()
    ap.add_argument("--dict-dir", required=True, help="the directory of cmudict.rep")
    ap.add_argument("--n", type=int, default=3000)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)

    from ..text.en_g2p import EnglishG2P

    cmu = read_cmu(args.dict_dir)
    random.seed(0)
    sample = random.sample([w for w in cmu if re.fullmatch(r"[a-z]{4,12}", w)], args.n)
    g = EnglishG2P(args.dict_dir)
    pairs = []
    for w in sample:  # each word predicted with its own entry out of the dictionary
        saved = g.cmu.pop(w, None)
        pairs.append((w, g.word_phones(w), list(cmu[w])))
        if saved is not None:
            g.cmu[w] = saved
    stats = analyse(pairs)
    report(stats, args.n, args.top)
    return stats


if __name__ == "__main__":
    main()
