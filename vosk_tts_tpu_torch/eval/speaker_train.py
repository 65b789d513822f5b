"""Trainable speaker embedder for the similarity eval protocol
(vosk_tts_tpu/eval/speaker_train.py).

The reference gates VC quality on Resemblyzer cosine similarity
(training/vc/eval-score.py:25-63, published avg 0.880 on the shipped
model, vc/README.md:24). Resemblyzer is a GE2E-trained LSTM d-vector net
whose checkpoint cannot be fetched here, so this module trains the same
architecture the port ships for QuickVC (``models.quickvc.
speaker_encoder_apply``) with the GE2E loss (Wan et al. 2018) on an
in-repo synthetic multi-voice corpus. The scores are not comparable to the
published absolute numbers, but they are stable across changes: the
artifact ``data/speaker_encoder.npz`` is committed (the JAX package's file,
byte for byte, in the bundle layout; it turns to the port's layout at
load), so similarity regressions in the VC/TTS stacks are detectable.

The corpus is numpy (the same ``rng`` gives the same arrays as the JAX
package); the mels are the port's ``ops.stft.mel_spectrogram``. Training
and embedding run on the card unless ``device`` says otherwise. The
optimizer is optax's ``chain(clip_by_global_norm(3.0), adam(lr))`` written
out: the update is scaled by max/norm only where the global norm exceeds
max, then Adam with bias correction and eps outside the square root.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..api import resolve_device
from ..models.quickvc import speaker_encoder_apply
from ..models.tree import TreeModule
from ..ops.stft import mel_spectrogram
from ..utils.params import LINEARS, from_port_layout, to_port_layout

ARTIFACT = os.path.join(os.path.dirname(__file__), "data", "speaker_encoder.npz")

#: mel front-end of the embedder (22.05 kHz eval protocol shapes)
MEL = dict(n_fft=1024, num_mels=40, sr=22050, hop=256, win=1024, fmin=0.0, fmax=None)
PARTIAL_FRAMES = 80  # ~0.93 s windows, averaged over the utterance
CLIP_NORM = 3.0
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


# ---------------------------------------------------------------------------
# Synthetic multi-voice corpus (no external data here).
# ---------------------------------------------------------------------------


def synthetic_voice(rng: np.random.Generator) -> dict:
    """A random 'voice': F0 + formant envelope + glottal tilt."""
    f0 = float(rng.uniform(85.0, 320.0))
    n_formants = 4
    centers = np.sort(rng.uniform(300.0, 4200.0, n_formants))
    bws = rng.uniform(60.0, 220.0, n_formants)
    gains = rng.uniform(0.5, 1.0, n_formants)
    tilt = float(rng.uniform(0.5, 1.5))  # spectral rolloff exponent
    return {"f0": f0, "centers": centers, "bws": bws, "gains": gains, "tilt": tilt}


def synthetic_utterance(rng: np.random.Generator, voice: dict,
                        n_sec: float = 1.2, sr: int = 22050) -> np.ndarray:
    """One 'utterance' of a voice: jittered harmonic stack shaped by the
    voice's formant envelope, with a random prosody contour (slow F0 drift +
    amplitude modulation) so utterances differ within a voice."""
    n = int(n_sec * sr)
    t = np.arange(n) / sr
    # slow F0 contour around the voice's base (vibrato-scale drift)
    drift = np.interp(t, np.linspace(0, n_sec, 6), rng.uniform(0.94, 1.06, 6))
    phase = 2 * np.pi * np.cumsum(voice["f0"] * drift) / sr
    src = sum(np.sin((k + 1) * phase + rng.uniform(0, 2 * np.pi))
              / (k + 1) ** voice["tilt"] for k in range(16))
    spec = np.fft.rfft(src)
    freqs = np.fft.rfftfreq(n, 1 / sr)
    env = sum(g * np.exp(-0.5 * ((freqs - fc) / bw) ** 2)
              for fc, bw, g in zip(voice["centers"], voice["bws"], voice["gains"]))
    wav = np.fft.irfft(spec * (env + 0.02), n=n)
    contour = np.interp(t, np.linspace(0, n_sec, 8), 0.3 + rng.uniform(0, 0.7, 8))
    wav = wav * contour + rng.standard_normal(n) * 3e-4  # light noise floor
    return (wav / (np.abs(wav).max() + 1e-9) * 0.5).astype(np.float32)


def _mels(wavs: torch.Tensor) -> torch.Tensor:
    """(B, samples) -> (B, frames, num_mels) on the waveforms' device."""
    return mel_spectrogram(wavs, MEL["n_fft"], MEL["num_mels"], MEL["sr"], MEL["hop"], MEL["win"],
                           MEL["fmin"], MEL["fmax"])


def _utterance_mel(wav: np.ndarray, device="cpu") -> np.ndarray:
    """One waveform -> its (frames, num_mels) log-mel, computed on ``device``."""
    with torch.inference_mode():
        wav = torch.as_tensor(np.asarray(wav, np.float32), device=device)
        return _mels(wav[None])[0].cpu().numpy()


# ---------------------------------------------------------------------------
# GE2E loss (Wan et al., "Generalized End-to-End Loss for Speaker
# Verification", the objective behind Resemblyzer's d-vectors).
# ---------------------------------------------------------------------------


def ge2e_loss(embeds: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """embeds: (N voices, M utts, D) L2-normalized. Softmax variant."""
    n, m, _ = embeds.shape
    centroids = embeds.mean(dim=1)  # (N, D)
    # exclusive centroid for own-voice similarity (eq. 8)
    excl = (centroids[:, None, :] * m - embeds) / (m - 1)  # (N, M, D)
    excl = excl / (torch.linalg.vector_norm(excl, dim=-1, keepdim=True) + 1e-6)
    cnorm = centroids / (torch.linalg.vector_norm(centroids, dim=-1, keepdim=True) + 1e-6)

    sim = torch.einsum("nmd,kd->nmk", embeds, cnorm)  # (N, M, N)
    own = torch.sum(embeds * excl, dim=-1)  # (N, M)
    eye = torch.eye(n, dtype=torch.bool, device=embeds.device)[:, None, :]
    sim = torch.where(eye, own[..., None], sim) * w + b
    # log-softmax CE against the own-voice column
    logz = torch.logsumexp(sim, dim=-1)
    pos = torch.diagonal(sim, dim1=0, dim2=2).transpose(0, 1)  # sim[n, :, n]: (N, M)
    return torch.mean(logz - pos)


def batch_loss(params, batch: torch.Tensor) -> torch.Tensor:
    """The GE2E loss of one batch (N voices, M utts, T, mel) under a
    port-layout tree {"enc", "w", "b"} of tensors, the LSTM in its training
    mode (the one whose backward cuDNN runs; no dropout, the same numbers)."""
    n, m, t, c = batch.shape
    e = speaker_encoder_apply(params["enc"], batch.reshape(n * m, t, c), train=True)
    e = torch.nan_to_num(e)  # relu can zero a whole embedding early on
    return ge2e_loss(e.reshape(n, m, -1), torch.clamp(params["w"], min=1e-2), params["b"])


def init_tree(seed: int, *, hidden: int = 64, emb: int = 64, layers: int = 2) -> dict:
    """Bundle-layout starting tree (the structure of the JAX package's
    ``speaker_encoder_init`` plus w = 10, b = -5): LSTM gates and the
    projection U(-1/sqrt(H), 1/sqrt(H)), zero projection bias; drawn from a
    CPU ``torch.Generator`` seeded with ``seed``."""
    g = torch.Generator().manual_seed(seed)
    s = hidden**-0.5
    u = lambda *shape: ((torch.rand(*shape, generator=g) * 2 - 1) * s).numpy()
    lstm = [{"w_ih": u(MEL["num_mels"] if i == 0 else hidden, 4 * hidden),
             "w_hh": u(hidden, 4 * hidden), "b_ih": u(4 * hidden), "b_hh": u(4 * hidden)}
            for i in range(layers)]
    return {"enc": {"lstm": lstm, "linear": {"w": u(hidden, emb),
                                             "b": np.zeros((emb,), np.float32)}},
            "w": np.asarray(10.0, np.float32), "b": np.asarray(-5.0, np.float32)}


class _ClipAdam:
    """optax.chain(clip_by_global_norm(CLIP_NORM), adam(lr)) over a list of
    parameters, in place."""

    def __init__(self, params, lr: float):
        self.params, self.lr, self.count = list(params), lr, 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        self.count += 1
        c1, c2 = 1 - ADAM_B1**self.count, 1 - ADAM_B2**self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = torch.where(norm < CLIP_NORM, g, g / norm * CLIP_NORM)
            mu.mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
            nu.mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
            p.sub_(self.lr * (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS))


def train_speaker_encoder(
    seed: int = 0,
    *,
    n_voices: int = 64,
    utts_per_voice: int = 6,
    voices_per_batch: int = 8,
    utts_per_batch: int = 4,
    steps: int = 400,
    hidden: int = 64,
    emb: int = 64,
    layers: int = 2,
    lr: float = 1e-3,
    log=None,
    device=None,
    params=None,
):
    """Train the LSTM speaker encoder with GE2E on a synthetic corpus (the
    voices, utterances and batches drawn from ``np.random.default_rng(seed)``
    in the JAX package's order). Starts from ``params`` (a bundle-layout
    numpy tree, e.g. the JAX package's init) or from :func:`init_tree` of
    ``seed``. Runs on
    ``device`` (default: the card). Returns (the trained bundle-layout
    numpy tree, {"loss": the last step's loss, "hidden", "emb", "layers"})
    for ``save_artifact``; ``log`` gets a line every 50 steps."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    voices = [synthetic_voice(rng) for _ in range(n_voices)]
    wavs = np.stack([synthetic_utterance(rng, v) for v in voices for _ in range(utts_per_voice)])
    with torch.no_grad():
        mels = _mels(torch.as_tensor(wavs, device=device))[:, :PARTIAL_FRAMES]
    mels = mels.reshape(n_voices, utts_per_voice, *mels.shape[1:])  # (V, U, T, mel)

    if params is None:
        params = init_tree(seed, hidden=hidden, emb=emb, layers=layers)
    module = TreeModule(to_port_layout(params), trainable=True).to(device)
    opt = _ClipAdam(module.parameters(), lr)

    loss = None
    for it in range(steps):
        vi = rng.choice(n_voices, voices_per_batch, replace=False)
        ui = rng.integers(0, utts_per_voice, size=(voices_per_batch, utts_per_batch))
        batch = mels[torch.as_tensor(vi[:, None], device=device),
                     torch.as_tensor(ui, device=device)]
        for p in module.parameters():
            p.grad = None
        loss = batch_loss(module.params, batch)
        loss.backward()
        opt.step()
        if log and it % 50 == 0:
            log(f"step {it}: ge2e {float(loss.detach()):.4f}")
    tree = from_port_layout(module.numpy_tree(), LINEARS)
    return tree, {"loss": float(loss.detach()) if loss is not None else None, "hidden": hidden,
                  "emb": emb, "layers": layers}


# ---------------------------------------------------------------------------
# Artifact + embedder callable.
# ---------------------------------------------------------------------------


def save_artifact(path: str, params, extra: dict) -> None:
    """Write a bundle-layout tree and its metadata as the committed
    artifact's npz (``params/...``, ``meta/...``)."""
    from ..utils.checkpoint import save_params

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    save_params(path, {"params": params, "meta": {k: np.asarray(v) for k, v in extra.items()}})


def load_artifact(path: str | None = None):
    """{"params": the bundle-layout tree, "meta": ...} of an artifact file
    (default: the committed one, :data:`ARTIFACT`)."""
    from ..utils.checkpoint import load_params

    return load_params(path or ARTIFACT)


def lstm_embedder(params=None, device=None):
    """Returns an ``embedder(wav, sample_rate)`` callable for
    harness.speaker_similarity, using partial-window averaging as
    vc/models.py:743-767 / Resemblyzer's embed_utterance: the encoder over
    80-frame windows every 40 frames (and the last 80), their mean, L2
    normalised. ``params``: a bundle-layout tree (default: the committed
    artifact); the mel and the encoder run on ``device`` (default: the
    card)."""
    device = resolve_device(device)
    if params is None:
        params = load_artifact()["params"]
    enc = TreeModule(to_port_layout(params["enc"])).to(device).params

    @torch.inference_mode()
    def _embed_windows(windows: torch.Tensor) -> np.ndarray:  # (K, T, mel)
        e = torch.nan_to_num(speaker_encoder_apply(enc, windows)).mean(dim=0)
        return (e / (torch.linalg.vector_norm(e) + 1e-9)).cpu().numpy()

    def embed(wav: np.ndarray, sample_rate: int) -> np.ndarray:
        if sample_rate != MEL["sr"]:
            # linear resample to the embedder's rate (eval-path only)
            n = int(round(len(wav) * MEL["sr"] / sample_rate))
            wav = np.interp(np.linspace(0, len(wav) - 1, n), np.arange(len(wav)), wav)
        mel = _utterance_mel(np.asarray(wav, np.float32), device)
        t = mel.shape[0]
        if t < PARTIAL_FRAMES:
            mel = np.pad(mel, ((0, PARTIAL_FRAMES - t), (0, 0)), mode="wrap")
            t = PARTIAL_FRAMES
        starts = list(range(0, t - PARTIAL_FRAMES + 1, PARTIAL_FRAMES // 2))
        if starts[-1] != t - PARTIAL_FRAMES:
            starts.append(t - PARTIAL_FRAMES)
        windows = np.stack([mel[s: s + PARTIAL_FRAMES] for s in starts])
        return _embed_windows(torch.as_tensor(windows, device=device))

    return embed
