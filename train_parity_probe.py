"""Repeat the ``[train-variants mono_inter+ms_istft/onnx+dp parity]`` step of
chip_smoke.py on the card, to tell where its spread comes from.

One corpus and one B2 pair, as chip_smoke.py writes them. Each round trains
the variant with run_vits2 --max-steps 2 at B24 (the last round in torch's
deterministic algorithms, so its trees are the same in every run), steps the
CPU once in f32 and once in f64 from the round's trees, then steps the card
from the same trees, noise and alignment again and again: ``--repeats`` times
with torch's default algorithms, as chip_smoke.py steps it; as often in
deterministic algorithms; and as often with all but the step's own peak
memory (plus 256 MiB) taken from the card, so that cuDNN finds less room for
workspace. Each reading prints every network's gradients against the f64
step (relative L2 of all tensors together, and the worst tensor's largest
error over its max) and a digest of the card's D gradients; each mode ends
with the spread of its D readings and how many digests it gave.

    python3 train_parity_probe.py [--rounds 3] [--repeats 8]

Needs one CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

import chip_smoke as cs


def d_digest(state):
    leaves = state.params["d"].leaves()
    return cs.digest_of([leaves[p].grad for p in sorted(leaves) if leaves[p].grad is not None])[:12]


def reading(state, ref64):
    out = {}
    for k in state.params:
        worst, where, l2 = cs.grad_errors(state.params[k], ref64.params[k])
        out[k] = {"l2": l2, "worst": worst, "where": where}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_parity_probe: no CUDA card", file=sys.stderr)
        return 1
    cs.full_float32()
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} cuDNN "
          f"{torch.backends.cudnn.version()}; {smi}")
    i, (_, over) = next((i, v) for i, v in enumerate(cs.TRAIN_VARIANTS)
                           if v[0].startswith("mono_inter"))
    summary = []
    with tempfile.TemporaryDirectory(prefix="parity-probe-") as root:
        cs.write_corpus(root)
        cfg_path = os.path.join(root, "variant.json")
        with open(cfg_path, "w", encoding="utf-8") as f:
            json.dump(cs.variant_train_config(root, over), f)
        mcfg, tcfg, dcfg = cs.run_vits2.build_configs(cs.variant_train_config(root, over))
        batch_np, _ = cs.corpus_batch(dcfg, dev)
        pair = {k: v[:2] for k, v in batch_np.items()}
        noise = cs.parity_noise(mcfg, pair, cs.TRAIN_SEED + 20 + i)
        for r in range(args.rounds):
            det = r == args.rounds - 1
            run = ["-c", cfg_path, "-m", os.path.join(root, f"round{r}"), "--max-steps", "2"]
            t0 = time.perf_counter()
            with cs.deterministic() if det else contextlib.nullcontext():
                state, _ = cs.run_vits2.main(run)
            t_run = time.perf_counter() - t0
            trees = {k: mod.numpy_tree() for k, mod in state.params.items()}
            del state
            tag = f"round {r} ({'deterministic' if det else 'default'} run_vits2 steps, trees " \
                  f"{cs.digest(trees)}, run_vits2 {t_run:.1f} s)"
            first, _, attn = cs.parity_step(mcfg, tcfg, trees, pair, noise, dev)
            del first
            ref64 = cs.parity_step(mcfg, tcfg, trees, pair, noise, cpu, torch.float64, attn=attn)[0]
            ref = cs.parity_step(mcfg, tcfg, trees, pair, noise, cpu, attn=attn)[0]
            print(f"[{tag}] CPU f32 against f64: {json.dumps(reading(ref, ref64))}")
            del ref
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            cs.parity_step(mcfg, tcfg, trees, pair, noise, dev)
            peak = torch.cuda.max_memory_allocated() - base
            for mode in ("default", "deterministic", "pressure"):
                d_l2, digests, blocker, t_steps = [], set(), None, []
                if mode == "pressure":
                    torch.cuda.empty_cache()
                    free = torch.cuda.mem_get_info()[0]
                    blocker = torch.empty(max(free - peak - (256 << 20), 0), dtype=torch.uint8,
                                          device=dev)
                for n in range(args.repeats):
                    t0 = time.perf_counter()
                    with cs.deterministic() if mode == "deterministic" else \
                            contextlib.nullcontext():
                        state = cs.parity_step(mcfg, tcfg, trees, pair, noise, dev)[0]
                    torch.cuda.synchronize()
                    t_steps.append(time.perf_counter() - t0)
                    got = reading(state, ref64)
                    d_l2.append(got["d"]["l2"])
                    digests.add(d_digest(state))
                    print(f"[{tag} {mode} {n}] card against f64: {json.dumps(got)}; D digest "
                          f"{d_digest(state)}")
                    del state
                del blocker
                torch.cuda.empty_cache()
                line = {"round": r, "trees": cs.digest(trees), "deterministic_trees": det,
                        "mode": mode, "repeats": args.repeats, "d_l2_min": min(d_l2),
                        "d_l2_max": max(d_l2), "d_digests": len(digests),
                        "over_limit": sum(v > cs.PARITY_GRAD_L2 for v in d_l2),
                        "step_peak_gib": peak / 2**30, "step_s_mean": sum(t_steps) / len(t_steps)}
                summary.append(line)
                print(f"[{tag} {mode}] {json.dumps(line)}")
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
