"""Rank process of the port's data- and tensor-parallel tests
(tests/test_torch_parallel.py), on the CPU over gloo. Imports no JAX.

    python tests/torch_parallel_worker.py --rank R --world N --store FILE \
        --out OUT [--noise DRAWS.npz] [--timeout S] SCENARIO [SCENARIO ...]

Joins the group through a file store (``file://FILE``, no port), builds
each named scenario's grid (GRIDS; by default all N ranks on the data
axis), runs the scenario with this rank's rows of its global batch and
saves its results to OUT.SCENARIO.pt. Without ``--store`` it runs the
scenarios with no axis: the 1-process reference on the global batch. Inputs come from seeded numpy generators (the configs
are small: a few layers, narrow widths); every random draw of a step is
pinned per row, so a rank's draws are its rows of the global ones.
"""

from __future__ import annotations

import argparse
import datetime
import gc
import hashlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from vosk_tts_tpu_torch.models import gpt_sovits as tg  # noqa: E402
from vosk_tts_tpu_torch.models import quickvc as tq  # noqa: E402
from vosk_tts_tpu_torch.models import stabletts as tst  # noqa: E402
from vosk_tts_tpu_torch.models import vits2 as tv  # noqa: E402
from vosk_tts_tpu_torch.models.tree import TreeModule  # noqa: E402
from vosk_tts_tpu_torch.ops import rvq  # noqa: E402
from vosk_tts_tpu_torch.parallel import mesh as M  # noqa: E402
from vosk_tts_tpu_torch.parallel import tp as TP  # noqa: E402
from vosk_tts_tpu_torch.train import gpt_sovits_train as tgt  # noqa: E402
from vosk_tts_tpu_torch.train import stabletts_train as tstt  # noqa: E402
from vosk_tts_tpu_torch.train import vc_train as tvc  # noqa: E402
from vosk_tts_tpu_torch.train import vits2_train as tt  # noqa: E402
from vosk_tts_tpu_torch.utils import params as P  # noqa: E402

GB = 4  # the global batch of every step scenario

# the VITS2 step: tests/multihost_worker.tiny_configs (every GAN structure,
# tiny depth), ragged lengths so that each rank's masks differ
VITS2 = dict(n_vocab=20, spec_channels=40, segment_size=8, inter_channels=16, hidden_channels=16,
             filter_channels=32, n_heads=2, n_layers=1, n_flows=1, posterior_wn_layers=2,
             sdp_n_flows=1, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
             upsample_rates=(4,), upsample_kernel_sizes=(8,), upsample_initial_channel=32,
             n_speakers=4, gin_channels=8)
VITS2_TRAIN = dict(filter_length=256, hop_length=tv.VITS2Config(**VITS2).upsample_factor,
                   win_length=256, n_mel_channels=40,
                   fft_sizes=(64, 128, 32), hop_sizes=(8, 16, 4), win_lengths=(32, 64, 16),
                   disc_periods=(2, 3), disc_spec_ffts=(64,))
# the 2 x 2 step's discriminators: one period, one FFT size (four ranks
# each hold a whole one)
DPTP_TRAIN = {**VITS2_TRAIN, "disc_periods": (2,), "disc_spec_ffts": (64,)}
TX, TF = 12, 24
X_LENGTHS, MEL_LENGTHS = (12, 9, 12, 7), (24, 19, 24, 15)

# the tensor-parallel generator: both resblock types, cond, several upsamples
TP_CFG = dict(n_vocab=20, inter_channels=16, hidden_channels=16, upsample_initial_channel=32,
              n_speakers=4, gin_channels=8, resblock_kernel_sizes=(3, 5),
              resblock_dilation_sizes=((1, 3), (1, 3)), upsample_rates=(4, 4),
              upsample_kernel_sizes=(8, 8))
TP_B, TP_T = 2, 12

AR = dict(embedding_dim=32, hidden_dim=32, num_head=4, num_layers=2, vocab_size=17,
          phoneme_vocab_size=64, bert_dim=8, eos=16)
S1_TX, S1_TY = 10, 12

SR, HOP, FILT, N_MEL = 3200, 32, 128, 20
SOVITS = dict(spec_channels=FILT // 2 + 1, segment_size=8, inter_channels=16, hidden_channels=16,
              filter_channels=32, n_heads=2, n_layers=2, resblock_kernel_sizes=(3,),
              resblock_dilation_sizes=((1, 3),), upsample_rates=(4, 4, 2),
              upsample_initial_channel=32, upsample_kernel_sizes=(8, 8, 4), gin_channels=16,
              ssl_dim=16, n_codes=16, n_symbols=64, mrte_hidden=16, style_hidden=8)
S2_TRAIN = dict(sampling_rate=SR, filter_length=FILT, hop_length=HOP, win_length=FILT,
                n_mel_channels=N_MEL)
S2_TF, S2_TT = 24, 12

STABLE = dict(n_spks=3, spk_emb_dim=8, hidden_channels=32, filter_channels=64, n_heads=2,
              n_layers=2, phone_emb_dim=16, punc_emb_dim=2, bert_dim=16, bert_proj_dim=8,
              dec_hidden=32, dec_filter=64, dec_layers=2, dec_heads=2)
ST_TX, ST_TF = 12, 40

VC_MODEL = dict(segment_size=8, inter_channels=16, hidden_channels=16, ssl_dim=8, gin_channels=16,
                resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
                upsample_rates=(2,), upsample_initial_channel=32, upsample_kernel_sizes=(4,))
VC_CFG = dict(spec_channels=FILT // 2 + 1, n_mel_channels=N_MEL, **VC_MODEL)
VC_TRAIN = dict(sampling_rate=SR, filter_length=FILT, hop_length=HOP, win_length=FILT,
                n_mel_channels=N_MEL)
VC_T = 24


def _mask(lengths, t):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


def rows(a, axis):
    """This rank's rows of a global array (equal shards, rank order)."""
    if axis is None:
        return a
    n = a.shape[0] // axis.size
    return a[axis.index * n:(axis.index + 1) * n]


def tensors(batch, axis=None, long=("x", "sid")):
    return {k: (torch.from_numpy(np.ascontiguousarray(rows(v, axis))).long() if k in long
                else torch.from_numpy(np.ascontiguousarray(rows(v, axis))))
            for k, v in batch.items()}


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def step_results(state, metrics, grid) -> dict:
    """The metrics, digests of each network's gradients and parameters
    after the step (equal on every rank of the data axis), and the
    gradients themselves ({network: {tree path: array}}) on the first data
    row (the 1-process run has one)."""
    out = {"metrics": metrics,
           "digest": {kind: {net: _digest(t.grad if kind == "grads" else t
                                          for t in m.parameters())
                             for net, m in state.params.items()}
                      for kind in ("grads", "params")}}
    if grid is None or grid.data.index == 0:
        out["grads"] = {net: {p: t.grad.detach().numpy().copy() for p, t in m.leaves().items()}
                        for net, m in state.params.items()}
    return out


def floats(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items()}


# ---------------------------------------------------------------------------
# Inputs (seeded; the test's JAX side reads the same)
# ---------------------------------------------------------------------------


def vits2_batch():
    rng = np.random.default_rng(0)
    hop = tv.VITS2Config(**VITS2).upsample_factor
    xm, ym = _mask(X_LENGTHS, TX), _mask(MEL_LENGTHS, TF)
    wav = (rng.standard_normal((GB, TF * hop)) * 0.3).astype(np.float32)
    wav *= np.repeat(ym, hop, axis=1)
    return {"x": (rng.integers(1, 20, size=(GB, TX)) * xm).astype(np.int32),
            "x_lengths": np.asarray(X_LENGTHS, np.int32),
            "mel": (rng.standard_normal((GB, TF, 40)) * ym[..., None]).astype(np.float32),
            "mel_lengths": np.asarray(MEL_LENGTHS, np.int32), "wav": wav,
            "sid": np.asarray([1, 3, 0, 2], np.int32)}


def vits2_trees(train=VITS2_TRAIN):
    """Bundle-layout (JAX-layout) G, D and durD trees from the numpy inits."""
    cfg, tcfg = tv.VITS2Config(**VITS2), tt.TrainConfig(**train)
    return {"g": P.perturb_zero_init(P.synthesizer_init(cfg, 0), seed=3),
            "d": P.mpmsd_init(1, tuple(tcfg.disc_periods), tuple(tcfg.disc_spec_ffts)),
            "dur": P.duration_disc_init(2, cfg.hidden_channels, cfg.hidden_channels, 3)}


def vits2_state(trees, tp_axis=None, train=VITS2_TRAIN):
    """The port's state of ``trees`` (bundle layout); with ``tp_axis`` the
    generator's decoder cut to this rank's part. Returns (state, tp)."""
    cfg, tcfg = tv.VITS2Config(**VITS2), tt.TrainConfig(**train)
    port = {k: P.to_port_layout(v) for k, v in trees.items()}
    tp = None
    if tp_axis is not None:
        port["g"]["dec"], tp = TP.shard_generator_params(port["g"]["dec"], tp_axis)
    return tt.init_train_state(cfg, tcfg, device="cpu", trees=port), tp


def tp_inputs():
    rng = np.random.default_rng(5)
    cfg = tv.VITS2Config(**TP_CFG)
    dec = P.synthesizer_init(cfg, 4)["dec"]
    z = rng.standard_normal((TP_B, TP_T, cfg.inter_channels)).astype(np.float32)
    g = rng.standard_normal((TP_B, 1, cfg.gin_channels)).astype(np.float32)
    dy = rng.standard_normal((TP_B, TP_T * cfg.upsample_factor, 1)).astype(np.float32)
    return dec, z, g, dy


def s1_batch():
    rng = np.random.default_rng(1)
    x_lens, y_lens = np.array([10, 7, 4, 9]), np.array([12, 9, 5, 11])
    xm, ym = _mask(x_lens, S1_TX), _mask(y_lens, S1_TY)
    return {"x": (rng.integers(1, 64, (GB, S1_TX)) * xm).astype(np.int32),
            "x_lengths": x_lens.astype(np.int32),
            "y": (rng.integers(0, 16, (GB, S1_TY)) * ym).astype(np.int32),
            "y_lengths": y_lens.astype(np.int32),
            "bert": (rng.standard_normal((GB, S1_TX, 8)) * xm[..., None]).astype(np.float32),
            "reject_ids": rng.integers(0, S1_TY, (GB, 2)).astype(np.int64)}


def s2_batch():
    rng = np.random.default_rng(10)
    spec_lens, text_lens = np.array([24, 19, 24, 15]), np.array([12, 7, 10, 12])
    centres = rng.standard_normal((5, 16)) * 3
    ssl = (centres[rng.integers(0, 5, GB * S2_TF)] + rng.standard_normal((GB * S2_TF, 16)))
    ssl = ssl.reshape(GB, S2_TF, 16).astype(np.float32)
    spec = np.abs(rng.standard_normal((GB, S2_TF, SOVITS["spec_channels"]))).astype(np.float32)
    text = rng.integers(1, 60, (GB, S2_TT)).astype(np.int32)
    wav = (rng.standard_normal((GB, S2_TF * HOP)) * 0.3).astype(np.float32)
    for i in range(GB):
        spec[i, spec_lens[i]:], ssl[i, spec_lens[i]:], text[i, text_lens[i]:] = 0, 0, 0
        wav[i, spec_lens[i] * HOP:] = 0
    noise = {"posterior": rng.standard_normal((GB, S2_TF, 16)).astype(np.float32),
             "ids_slice": (rng.uniform(size=GB) * np.maximum(spec_lens - 8 + 1, 1)).astype(
                 np.int64),
             # the rows of the 25 Hz codes' features (stride 2)
             "kmeans_ids": rng.permutation(GB * S2_TF // 2)[:16].astype(np.int64)}
    return {"ssl": ssl, "spec": spec, "spec_lengths": spec_lens.astype(np.int32), "text": text,
            "text_lengths": text_lens.astype(np.int32), "wav": wav}, noise


def stable_batches(n=4):
    """``n`` micro-batches with their draws."""
    rng = np.random.default_rng(2)
    out = []
    for _ in range(n):
        x_lens = rng.integers(6, ST_TX + 1, GB)
        y_lens = rng.integers(20, ST_TF + 1, GB)
        xm, ym = _mask(x_lens, ST_TX), _mask(y_lens, ST_TF)
        batch = {"x": (rng.integers(1, 200, (GB, 5, ST_TX)) * xm[:, None]).astype(np.int32),
                 "x_lengths": x_lens.astype(np.int32),
                 "mel": (rng.standard_normal((GB, ST_TF, 80)) * ym[..., None]).astype(np.float32),
                 "mel_lengths": y_lens.astype(np.int32),
                 "sid": rng.integers(0, 3, GB).astype(np.int32),
                 "bert": (rng.standard_normal((GB, ST_TX, 16)) * xm[..., None]).astype(np.float32),
                 "durations": (rng.integers(1, 5, (GB, ST_TX)) * xm).astype(np.int32)}
        noise = {"cfg": rng.uniform(size=(GB, 1)).astype(np.float32),
                 "t": rng.uniform(size=(GB, 1, 1)).astype(np.float32),
                 "z": rng.standard_normal((GB, ST_TF, 80)).astype(np.float32)}
        out.append((batch, noise))
    return out


def vc_batch():
    rng = np.random.default_rng(3)
    batch = {"c": rng.standard_normal((GB, VC_T, 8)).astype(np.float32),
             "spec": np.abs(rng.standard_normal((GB, VC_T, VC_CFG["spec_channels"]))).astype(
                 np.float32),
             "mel": rng.standard_normal((GB, VC_T, N_MEL)).astype(np.float32) - 3,
             "wav": (rng.standard_normal((GB, VC_T * HOP)) * 0.3).astype(np.float32)}
    noise = {"posterior_p": rng.standard_normal((GB, VC_T, 16)).astype(np.float32),
             "posterior_q": rng.standard_normal((GB, VC_T, 16)).astype(np.float32),
             "ids_slice": (rng.uniform(size=GB) * (VC_T - 8 + 1)).astype(np.int64)}
    return batch, noise


# ---------------------------------------------------------------------------
# Scenarios: each takes the grid (None: one process) and returns numpy results
# ---------------------------------------------------------------------------


def vits2_dp(grid=None, noise=None, train=VITS2_TRAIN):
    """One VITS2 GAN step on this rank's rows (``noise``: the global draws),
    tensor-parallel where the grid has a model axis of more than one rank."""
    dp = None if grid is None else grid.data
    tp_axis = None if grid is None or grid.n_model == 1 else grid.model
    state, tp = vits2_state(vits2_trees(train), tp_axis, train)
    step = tt.make_train_step(tv.VITS2Config(**VITS2), tt.TrainConfig(**train), dp=dp, tp=tp)
    metrics = step(state, tensors(vits2_batch(), dp),
                   noise={k: torch.tensor(rows(v, dp)) for k, v in noise.items()})
    return step_results(state, floats(metrics), grid)


def tp_generator(grid=None):
    """The generator forward and the gradients of sum(out * dy), with this
    rank's part of the weights over the model axis."""
    cfg = tv.VITS2Config(**TP_CFG)
    dec, z, g, dy = tp_inputs()
    port = P.to_port_layout(dec)
    tp = None
    if grid is not None:
        port, tp = TP.shard_generator_params(port, grid.model)
    module = TreeModule(port, trainable=True)
    zt = torch.from_numpy(z).requires_grad_(True)
    out, _ = tv.generator_apply(module.params, cfg, zt, torch.from_numpy(g), tp=tp)
    (out * torch.from_numpy(dy)).sum().backward()
    return {"out": out.detach().numpy(), "z_grad": zt.grad.numpy(),
            "grads": {p: t.grad.numpy() for p, t in module.leaves().items()},
            "shapes": {p: tuple(t.shape) for p, t in module.leaves().items()}}


def mpd_two(seed):
    """``mpd_init(seed)``'s DiscriminatorS and its first two periods (the
    tests' step discriminator), drawn alone."""
    rng = np.random.default_rng(seed)
    return {"s": P._disc_s(rng), "p": [P._disc_p(rng) for _ in range(2)]}


def s1(grid=None, dpo=False):
    dp = None if grid is None else grid.data
    cfg = tg.ARConfig(**AR)
    tcfg = tgt.S1TrainConfig(if_dpo=dpo, optimizer="adamw" if dpo else "scaled_adam")
    state = tgt.init_s1_state(cfg, tcfg, device="cpu",
                              tree=P.to_port_layout(P.ar_init(cfg, seed=0)))
    batch = s1_batch()
    reject = batch.pop("reject_ids")
    metrics = tgt.make_s1_step(cfg, tcfg, dp=dp)(
        state, tensors(batch, dp, long=("x", "y")),
        noise={"reject_ids": torch.from_numpy(rows(reject, dp))})
    return step_results(state, floats(metrics), grid)


def s2(grid=None):
    dp = None if grid is None else grid.data
    cfg, tcfg = tg.SoVITSConfig(**SOVITS), tgt.S2TrainConfig(**S2_TRAIN)
    trees = {"g": P.perturb_zero_init(P.sovits_init(cfg, 0), seed=1), "d": mpd_two(2)}
    port = {k: P.to_port_layout(v) for k, v in trees.items()}
    del port["g"]["codebook"]
    state = tgt.init_s2_state(cfg, tcfg, device="cpu", trees=port)
    batch, noise = s2_batch()
    step_noise = {"posterior": torch.from_numpy(rows(noise["posterior"], dp)),
                  "ids_slice": torch.from_numpy(rows(noise["ids_slice"], dp)),
                  "kmeans_ids": torch.from_numpy(noise["kmeans_ids"])}
    step = tgt.make_s2_step(cfg, tcfg, dp=dp)
    metrics = [floats(step(state, tensors(batch, dp, long=("text",)), noise=step_noise))
               for _ in range(2)]
    return {**step_results(state, metrics, grid),
            "vq": {k: v.numpy().copy() for k, v in state.vq.items()}}


def stable(grid=None):
    dp = None if grid is None else grid.data
    cfg, tcfg = tst.StableTTSConfig(**STABLE), tstt.StableTrainConfig()
    tree = tst.port_layout(P.perturb_matcha_zero_init(P.matcha_init(cfg, 0), seed=1))
    state = tstt.init_train_state(cfg, tcfg, device="cpu", tree=tree)
    step = tstt.make_train_step(cfg, tcfg, dp=dp)
    metrics = [floats(step(state, tensors(b, dp),
                           noise={k: torch.from_numpy(rows(v, dp)) for k, v in n.items()}))
               for b, n in stable_batches(tcfg.accumulate)]
    return step_results(state, metrics, grid)


def vc(grid=None):
    dp = None if grid is None else grid.data
    cfg, tcfg = tq.QuickVCConfig(**VC_CFG), tvc.VCTrainConfig(**VC_TRAIN)
    trees = {"g": P.perturb_zero_init(P.quickvc_init(cfg, 0), seed=3), "d": mpd_two(1)}
    state = tvc.init_train_state(cfg, tcfg, device="cpu",
                                 trees={k: P.to_port_layout(v) for k, v in trees.items()})
    batch, noise = vc_batch()
    metrics = tvc.make_train_step(cfg, tcfg, dp=dp)(
        state, tensors(batch, dp), noise={k: torch.from_numpy(rows(v, dp)) for k, v in noise.items()})
    return step_results(state, floats(metrics), grid)


def rvq_buffers(grid=None):
    """k-means then two EMA steps on rows whose count differs by rank."""
    dp = None if grid is None else grid.data
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((5, 16))[rng.integers(0, 5, 70)] * 3
         + rng.standard_normal((70, 16))).astype(np.float32)
    cut = [0, 30, 70] if dp is not None and dp.size == 2 else [0, 70]
    local = torch.from_numpy(x[cut[dp.index]:cut[dp.index + 1]] if dp is not None else x)
    ids = torch.from_numpy(rng.permutation(70)[:16])
    st = rvq.kmeans_init(rvq.state_init(16, 16), local, kmeans_iters=10, ids=ids, dp=dp)
    out = {"kmeans": {k: v.numpy().copy() for k, v in st.items()}}
    for _ in range(2):
        st = rvq.ema_step(st, local, dp=dp)
    out["ema"] = {k: v.numpy().copy() for k, v in st.items()}
    return out


def vits2_noise():
    """Per-row draws of the VITS2 step (the test replaces them with the JAX
    step's own, made from its key)."""
    rng = np.random.default_rng(9)
    cfg = tv.VITS2Config(**VITS2)
    return {"posterior": rng.standard_normal((GB, TF, cfg.inter_channels)).astype(np.float32),
            "e_q": rng.standard_normal((GB, TX, 2)).astype(np.float32),
            "z": rng.standard_normal((GB, TX, 2)).astype(np.float32),
            "ids_slice": (rng.uniform(size=GB) * np.maximum(np.asarray(MEL_LENGTHS)
                                                            - cfg.segment_size + 1, 1)).astype(
                np.int64)}


SCENARIOS = {"vits2": vits2_dp,
             "dptp": lambda grid=None, noise=None: vits2_dp(grid, noise, DPTP_TRAIN),
             "tp": tp_generator, "s1": s1,
             "s1_dpo": lambda grid=None: s1(grid, dpo=True), "s2": s2, "stable": stable,
             "vc": vc, "rvq": rvq_buffers}
VITS2_STEPS = ("vits2", "dptp")
#: the grid (n_data, n_model) of each scenario over N ranks
GRIDS = {"dptp": lambda n: (n // 2, 2), "tp": lambda n: (1, n)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--store", default=None, help="the group's file store (none: no group)")
    ap.add_argument("--out", required=True, help="a scenario's results go to OUT.SCENARIO.pt")
    ap.add_argument("--noise", default=None, help="a .npz of the VITS2 step's global draws")
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("scenarios", nargs="+")
    args = ap.parse_args()
    torch.set_num_threads(1)
    if args.store:
        M.initialize(f"file://{args.store}", args.world, args.rank, device="cpu",
                     timeout=datetime.timedelta(seconds=args.timeout))
    noise = dict(np.load(args.noise)) if args.noise else vits2_noise()
    for name in args.scenarios:
        grid = (M.make_grid(*GRIDS.get(name, lambda n: (n, 1))(args.world)) if args.store
                else None)
        fn = SCENARIOS[name]
        torch.save(fn(grid, noise=noise) if name in VITS2_STEPS else fn(grid),
                   f"{args.out}.{name}.pt")
        gc.collect()
    if args.store:
        M.shutdown()


if __name__ == "__main__":
    main()
