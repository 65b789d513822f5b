"""Data- and tensor-parallel training and multi-device ``synth_batch`` of the
PyTorch port (vosk_tts_tpu_torch/parallel/), on the CPU over gloo.

The ranks are processes started from tests/torch_parallel_worker.py (which
imports no JAX), joined through a file store in ``tmp_path`` (no port),
one thread each, with a timeout on the group and on every join. One job
of 2 ranks runs the VITS2 step, the tensor-parallel generator (model axis
2), the S1 (ScaledAdam; AdamW with DPO), S2, StableTTS (one 4-micro-step
cycle) and VC steps and the codebook's buffers; one job of 4 ranks runs the
2 x 2 data x tensor-parallel VITS2 step (one period and one FFT size in its
discriminators). Each is held to the same function run with no axis in a
process of its own (the 1-process step on the global batch); the JAX step
runs in another before it, and the jobs one after another, so that the
file's memory peak is about one job's:

* every data-parallel step: each loss within 1e-5 relative, each network's
  reduced gradient within 1e-4 relative L2, gradients, parameters after
  the step (and S2's EMA buffers) equal on every rank;
* the VITS2 2-rank step also against the JAX package's step on the global
  batch (tiny config of tests/multihost_worker.tiny_configs, global B4,
  ragged lengths, the JAX step's draws fed per row) with
  tests/test_torch_train.py's gates: losses 1e-4 relative, each gradient
  1e-3 x its largest magnitude (a tensor whose JAX gradient is below 1e-6
  x its network's largest held to that floor);
* the tensor-parallel generator (both resblock types, cond, two upsamples):
  each rank holds the shapes JAX's ``generator_tp_shardings`` gives a
  device of a model axis of 2; its output within 1e-4 x peak of the
  unsharded generator's and of JAX's ``generator_apply``, the gradients
  of sum(out * dy) (each rank's slice of the whole) within 1e-4 relative L2;
* the 2 x 2 step: its losses within rtol 5e-4 / atol 1e-5 of the
  1-process step's (``dryrun_multichip``'s tolerances), each network's
  gradient (the model axis's shards put back together) within 1e-4
  relative L2, the replicated leaves' gradients equal across the model
  axis;
* k-means and two EMA steps over rows whose count differs by rank: every
  rank's buffers equal, k-means equal to the 1-process run, the EMA within
  1e-5 of its largest magnitude;
* the host-sharded batchers yield exactly the JAX batchers' index lists
  (and, for ShuffleBatcher, the same collate draws) for 2 and 3 hosts over
  3 epochs;
* ``Synth.synth_batch`` on ``["cpu", "cpu"]`` against ``["cpu"]`` for 3
  texts (padded to 4), noise 0: equal lengths, within 2 int16 LSB.
"""

import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from jax.sharding import Mesh

import torch_parallel_worker as W
from torch_shared import shared
from vosk_tts_tpu.models import vits2 as jv
from vosk_tts_tpu.parallel import tp as jtp
from vosk_tts_tpu.train import vits2_train as jt
from vosk_tts_tpu.train.data import BucketBatcher as JBucketBatcher
from vosk_tts_tpu.train.gpt_sovits_data import ShuffleBatcher as JShuffleBatcher
from vosk_tts_tpu_torch import api
from vosk_tts_tpu_torch.models import vits2 as tv
from vosk_tts_tpu_torch.text import plain_symbol_map
from vosk_tts_tpu_torch.train.data import BucketBatcher
from vosk_tts_tpu_torch.train.gpt_sovits_data import ShuffleBatcher
from vosk_tts_tpu_torch.utils import params as P
from vosk_tts_tpu_torch.utils.checkpoint import _flatten, save_params

WORKER = Path(__file__).with_name("torch_parallel_worker.py")
JOB_TIMEOUT = 180  # seconds for a job of ranks; each collective times out at 120
TWO_RANKS = ("vits2", "tp", "s1", "s1_dpo", "s2", "stable", "vc", "rvq")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def _rel(got, want, tol, what="", floor=0.0):
    """max |got - want| <= tol x max |want| (+ ``floor``)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale + floor + 1e-12, (what, err, scale)
    return err / max(scale, 1e-30)


def _rel_l2(got, want):
    return float(np.linalg.norm(np.asarray(got) - want) / max(np.linalg.norm(want), 1e-30))


def _flat(grads: dict) -> np.ndarray:
    return np.concatenate([g.ravel() for g in grads.values()])


def _start(tmp_path, world, scenarios, noise):
    """Start the ranks of a job (``world`` None: one process with no group,
    the 1-process reference); returns the list of processes."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    np.savez(tmp_path / "noise.npz", **noise)
    args = ["--noise", str(tmp_path / "noise.npz"), *scenarios]
    if world is None:
        ranks = [["--out", str(tmp_path / "ref")]]
    else:
        ranks = [["--rank", str(r), "--world", str(world), "--store", str(tmp_path / "store"),
                  "--timeout", "120", "--out", str(tmp_path / f"rank{r}")] for r in range(world)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, str(WORKER), *r, *args], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, env=env) for r in ranks]


def _join(procs):
    """Wait for every rank (killing all on a timeout)."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOB_TIMEOUT)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"


# ---------------------------------------------------------------------------
# The JAX package's VITS2 step on the global batch
# ---------------------------------------------------------------------------


def _jax_noise(key, cfg):
    """forward_train's draws from ``key``, as the JAX package makes them
    (vits2.py:897's split), for the global batch."""
    b = W.GB
    r_post, _, r_dp, r_slice = jax.random.split(key, 4)
    r_dp1, r_dp2 = jax.random.split(r_dp)
    r1, _ = jax.random.split(r_dp1)
    u = jax.random.uniform(r_slice, (b,))
    ids_max = np.maximum(np.asarray(W.MEL_LENGTHS) - cfg.segment_size + 1, 1)
    return {"posterior": np.asarray(jax.random.normal(r_post, (b, W.TF, cfg.inter_channels))),
            "e_q": np.asarray(jax.random.normal(r1, (b, W.TX, 2))),
            "z": np.asarray(jax.random.normal(r_dp2, (b, W.TX, 2))),
            "ids_slice": np.asarray((u * ids_max.astype(np.float32)).astype(jnp.int32)).astype(
                np.int64)}


def _recording(make):
    """make_optimizer whose state also keeps the last gradients it was given."""
    def wrapped(tcfg):
        inner = make(tcfg)

        def init(params):
            return inner.init(params), jax.tree.map(jnp.zeros_like, params)

        def update(grads, state, params=None):
            updates, inner_state = inner.update(grads, state[0], params)
            return updates, (inner_state, grads)
        return optax.GradientTransformation(init, update)
    return wrapped


def _jax_step(seed):
    """The JAX step's metrics and the gradients each optimizer was given, on
    the global batch with the draws of ``PRNGKey(seed)``."""
    jcfg, tcfg = jv.VITS2Config(**W.VITS2), jt.TrainConfig(**W.VITS2_TRAIN)
    make = jt.make_optimizer
    jt.make_optimizer = _recording(make)
    try:
        step, opt = jt.make_train_step(jcfg, tcfg), jt.make_optimizer(tcfg)

        def run(params, batch, key):
            state = {"step": jnp.zeros((), jnp.int32),
                     **{f"params_{k}": v for k, v in params.items()},
                     **{f"opt_{k}": opt.init(v) for k, v in params.items()}}
            new_state, metrics = step(state, batch, key)
            return metrics, {k: new_state[f"opt_{k}"][1] for k in params}

        metrics, grads = jax.jit(run)(W.vits2_trees(), {k: jnp.asarray(v) for k, v in
                                                        W.vits2_batch().items()},
                                      jax.random.PRNGKey(seed))
    finally:
        jt.make_optimizer = make
    return {k: float(v) for k, v in metrics.items()}, jax.device_get(grads)


class Runs:
    """The jobs' results, loaded when a test reads them (each rank's and
    the reference's scenario files)."""

    def __init__(self, root, jax_step):
        self.root, self.jax = root, jax_step

    def ref(self, name):
        return torch.load(self.root / "ref" / f"ref.{name}.pt", weights_only=False)

    def ranks(self, job, name):
        n = {"two": 2, "four": 4}[job]
        return [torch.load(self.root / job / f"rank{r}.{name}.pt", weights_only=False)
                for r in range(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX step (in a process of its own, so that its compile's memory
    goes with it), then the 1-process reference, then the 2-rank job, then
    the 4-rank job: one at a time, so that the file's memory peak is one
    job's. Built once a run and read by every xdist worker
    (tests/torch_shared.py)."""
    def build(root):
        noise = _jax_noise(jax.random.PRNGKey(1), jv.VITS2Config(**W.VITS2))
        with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
            jax_step = pool.submit(_jax_step, 1).result(timeout=JOB_TIMEOUT)
        _join(_start(root / "ref", None, (*TWO_RANKS, "dptp"), noise))
        _join(_start(root / "two", 2, TWO_RANKS, noise))
        _join(_start(root / "four", 4, ("dptp",), noise))
        return jax_step

    return Runs(*shared(tmp_path_factory, "parallel", build))


def _check_dp(got, ref, name):
    """Losses 1e-5 relative, each network's gradient 1e-4 relative L2, the
    gradients and parameters after the step (digests) equal on every rank."""
    metrics = got[0]["metrics"]
    for m, mr in zip(metrics if isinstance(metrics, list) else [metrics],
                     ref["metrics"] if isinstance(metrics, list) else [ref["metrics"]]):
        assert set(m) == set(mr)
        for k in m:
            assert abs(m[k] - mr[k]) <= 1e-5 * abs(mr[k]) + 1e-12, (name, k, m[k], mr[k])
    worst = {}
    for net, g in got[0]["grads"].items():
        worst[net] = _rel_l2(_flat(g), _flat(ref["grads"][net]))
        assert worst[net] <= 1e-4, (name, net, worst[net])
    for other in got[1:]:
        assert other["digest"] == got[0]["digest"], name
        assert other["metrics"] == got[0]["metrics"], name
    return worst


def test_vits2_step_matches_one_process(runs):
    worst = _check_dp(runs.ranks("two", "vits2"), runs.ref("vits2"), "vits2")
    print(f"vits2 2 ranks: gradients' relative L2 to the 1-process step {worst}")


def test_vits2_step_matches_jax_global_batch(runs):
    """The 2-rank step against the JAX step on the global batch, with
    tests/test_torch_train.py's gates."""
    got = runs.ranks("two", "vits2")[0]
    jax_metrics, jax_grads = runs.jax
    assert set(got["metrics"]) == set(jax_metrics)
    worst = max(_rel(got["metrics"][k], np.float32(w), 1e-4, k) for k, w in jax_metrics.items())
    print(f"losses: worst relative difference to JAX {worst:.3e}")
    for net in ("g", "d", "dur"):
        want = _flatten(P.to_port_layout(jax_grads[net]))
        leaves = got["grads"][net]
        assert set(leaves) == set(want)
        floor = 1e-6 * max(float(np.abs(w).max()) for w in want.values())
        for path, g in leaves.items():
            tiny = float(np.abs(want[path]).max()) < floor
            _rel(g, want[path], 1e-3, f"{net} {path}", floor=floor if tiny else 0.0)


def _jax_tp_shapes():
    """The port-layout shapes of one device's shards of JAX's
    ``generator_tp_shardings`` on a model axis of 2."""
    dec = W.tp_inputs()[0]
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    shardings = jtp.generator_tp_shardings(mesh, dec)
    shard = jax.tree.map(lambda a, s: None if a is None else
                         np.zeros(s.shard_shape(a.shape), np.float32), dec, shardings,
                         is_leaf=lambda x: x is None)
    return {p: a.shape for p, a in _flatten(P.to_port_layout(shard)).items()}


def test_tp_generator_matches_unsharded_and_jax(runs):
    ref = runs.ref("tp")
    cfg = jv.VITS2Config(**W.TP_CFG)
    dec, z, g, dy = W.tp_inputs()

    def loss(params, z):
        out = jv.generator_apply(params, cfg, z, g)[0]
        return jnp.sum(out * dy), out

    (_, j_out), (j_grads, j_zgrad) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                                has_aux=True))(dec, jnp.asarray(z))
    j_grads = _flatten(P.to_port_layout(jax.device_get(j_grads)))
    shapes = _jax_tp_shapes()
    full = ref["shapes"]
    assert any(shapes[p] != full[p] for p in full), "nothing is sharded"
    for r, out in enumerate(runs.ranks("two", "tp")):
        _rel(out["out"], ref["out"], 1e-4, f"rank {r} out vs unsharded")
        _rel(out["out"], np.asarray(j_out), 1e-4, f"rank {r} out vs JAX")
        assert _rel_l2(out["z_grad"], np.asarray(j_zgrad)) <= 1e-4
        assert out["shapes"] == shapes, (r, out["shapes"], shapes)
        for p, gr in out["grads"].items():
            if out["shapes"][p] == full[p]:
                sl = (slice(None),) * gr.ndim
            else:  # this rank's slice along the one dimension cut in half
                d = next(i for i, (a, b) in enumerate(zip(out["shapes"][p], full[p])) if a != b)
                n = out["shapes"][p][d]
                sl = (slice(None),) * d + (slice(r * n, (r + 1) * n),)
            assert _rel_l2(gr, ref["grads"][p][sl]) <= 1e-4, (r, p)
            assert _rel_l2(gr, j_grads[p][sl]) <= 1e-4, (r, p, "JAX")


def test_dp_tp_step_matches_one_process(runs):
    """The 2 (data) x 2 (model) step, rank = data x 2 + model."""
    ref, outs = runs.ref("dptp"), runs.ranks("four", "dptp")
    for k, v in ref["metrics"].items():
        for o in outs:
            np.testing.assert_allclose(o["metrics"][k], v, rtol=5e-4, atol=1e-5, err_msg=k)
    for net, want in ref["grads"].items():
        got = {}  # the first data row's model pair (ranks 0, 1), put back together
        for path, w in want.items():
            a, b = outs[0]["grads"][net][path], outs[1]["grads"][net][path]
            if a.shape == w.shape:
                np.testing.assert_array_equal(a, b, err_msg=f"{net} {path}")
                got[path] = a
            else:
                dim = next(i for i, (x, y) in enumerate(zip(a.shape, w.shape)) if x != y)
                got[path] = np.concatenate([a, b], axis=dim)
        assert _rel_l2(_flat(got), _flat(want)) <= 1e-4, net
    for m in (0, 1):  # the second data row holds what the first does
        assert outs[2 + m]["digest"] == outs[m]["digest"]


@pytest.mark.parametrize("name", ["s1", "s1_dpo", "s2", "stable", "vc"])
def test_trainer_steps_match_one_process(runs, name):
    got, ref = runs.ranks("two", name), runs.ref(name)
    worst = _check_dp(got, ref, name)
    print(f"{name} 2 ranks: gradients' relative L2 to the 1-process step {worst}")
    if name == "s2":  # the codebook's EMA buffers after k-means and two steps
        got = [o["vq"] for o in got]
        for k, v in ref["vq"].items():
            np.testing.assert_array_equal(got[1][k], got[0][k], err_msg=k)
            _rel(got[0][k], v, 1e-5, k)


def test_codebook_buffers_with_unequal_rows(runs):
    got, ref = runs.ranks("two", "rvq"), runs.ref("rvq")
    for phase in ("kmeans", "ema"):
        for k, v in ref[phase].items():
            np.testing.assert_array_equal(got[1][phase][k], got[0][phase][k], err_msg=k)
            if phase == "kmeans":
                np.testing.assert_array_equal(got[0][phase][k], v, err_msg=k)
            else:
                _rel(got[0][phase][k], v, 1e-5, k)


# ---------------------------------------------------------------------------
# Host-sharded batchers (no process group)
# ---------------------------------------------------------------------------


class _Lengths:
    """A dataset of lengths only; ``collate`` returns the indices and one
    draw of the epoch's generator (the VC windows read it)."""

    def __init__(self, n, seed):
        self.lengths = list(np.random.default_rng(seed).integers(40, 900, n))

    def __len__(self):
        return len(self.lengths)

    def collate(self, idxs, rng=None):
        return list(idxs), (None if rng is None else int(rng.integers(1 << 30)))


@pytest.mark.parametrize("hosts", [2, 3])
@pytest.mark.parametrize("kind", ["bucket", "shuffle"])
def test_host_sharded_batchers_equal_jax(kind, hosts):
    ds = _Lengths(53, 4)
    for host in range(hosts):
        if kind == "bucket":
            got = BucketBatcher(ds, 4, host_id=host, num_hosts=hosts)
            want = JBucketBatcher(ds, 4, host_id=host, num_hosts=hosts)
            got.collate = want.collate = lambda idxs: list(idxs)
        else:
            got = ShuffleBatcher(ds, 4, host_id=host, num_hosts=hosts)
            want = JShuffleBatcher(ds, 4, host_id=host, num_hosts=hosts)
        assert got.num_batches() == want.num_batches()
        for epoch in range(3):
            assert list(got.epoch(epoch)) == list(want.epoch(epoch)), (kind, hosts, host, epoch)


# ---------------------------------------------------------------------------
# synth_batch over devices
# ---------------------------------------------------------------------------


SYNTH = dict(inter_channels=32, hidden_channels=32, filter_channels=64, n_layers=2,
             upsample_initial_channel=64, n_speakers=2, gin_channels=16)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    cfg = tv.VITS2Config(**SYNTH)
    out = tmp_path_factory.mktemp("synthbundle") / "vosk-model-tts-ru-parallel-test"
    out.mkdir()
    save_params(out / "params.npz", P.perturb_zero_init(P.synthesizer_init(cfg, seed=0), seed=1))
    with open(out / "config.json", "w", encoding="utf-8") as f:
        json.dump({"model_type": "vits2", "sample_rate": 22050,
                   "phoneme_id_map": {k: [v] for k, v in plain_symbol_map().items()},
                   "inference": {}, "model": dataclasses.asdict(cfg)}, f, ensure_ascii=False)
    (out / "dictionary").write_text("привет 1.0 p rj i0 vj e1 t\n", encoding="utf-8")
    return out


def test_synth_batch_over_two_replicas(bundle):
    synth = api.Synth(api.Model(bundle, device="cpu"))
    texts = ["привет мир", "как дела сегодня", "да"]
    kw = dict(speaker_ids=[0, 1, 0], noise_level=0.0, duration_noise_level=0.0)
    one = synth.synth_batch(texts, devices=["cpu"], **kw)
    two = synth.synth_batch(texts, devices=["cpu", "cpu"], **kw)
    assert len(synth._replicas) == 1  # the second shard's copy
    assert [len(a) for a in two] == [len(a) for a in one]
    for a, b in zip(two, one):
        assert np.abs(a.astype(np.int32) - b).max() <= 2


def test_ranks_import_no_jax():
    """The ranks' module and the parallel modules import neither JAX nor
    the JAX package."""
    code = ("import sys; sys.path.insert(0, 'tests'); import torch_parallel_worker; "
            "import vosk_tts_tpu_torch.parallel.mesh, vosk_tts_tpu_torch.parallel.tp; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'vosk_tts_tpu')))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=WORKER.parent.parent, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout


@pytest.mark.parametrize("cards, local_rank, local_world, backend, index", [
    (1, "0", None, "nccl", 0),  # one rank a card
    (2, "1", "2", "nccl", 1),
    (1, "1", "2", "gloo", 0),  # two ranks on one card: NCCL refuses them
])
def test_initialize_picks_the_backend(monkeypatch, cards, local_rank, local_world, backend,
                                      index):
    """CUDA ranks join over NCCL on ``cuda:(LOCAL_RANK mod the cards)``,
    over gloo where LOCAL_WORLD_SIZE exceeds the cards (the group itself is
    stubbed: this checks the choice only)."""
    from vosk_tts_tpu_torch.parallel import mesh as M

    seen = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: seen.update(set_device=d))
    monkeypatch.setattr(M.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(M.dist, "init_process_group",
                        lambda b, **kw: seen.update(backend=b, **kw))
    monkeypatch.setenv("LOCAL_RANK", local_rank)
    if local_world is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local_world)
    dev = M.initialize("file:///unused", 2, int(local_rank), device="cuda")
    assert dev == seen["set_device"] == torch.device("cuda", index)
    assert seen["backend"] == backend and seen["world_size"] == 2
    assert ("device_id" in seen) == (backend == "nccl")
    seen.clear()
    assert M.initialize("file:///unused", 2, 0, device="cpu") == torch.device("cpu")
    assert seen["backend"] == "gloo" and "device_id" not in seen and "set_device" not in seen
