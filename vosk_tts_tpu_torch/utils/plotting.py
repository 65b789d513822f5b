"""TensorBoard image helpers (vosk_tts_tpu/utils/plotting.py; the
reference's utils.py:85-137 mel and alignment plots). No driver of the port
logs images yet."""

from __future__ import annotations

import numpy as np


def plot_spectrogram_to_numpy(spectrogram: np.ndarray) -> np.ndarray:
    """(n_mel, T) -> HWC uint8 image (matplotlib where it imports, else the
    values scaled to 0..255 in three equal channels)."""
    spectrogram = np.asarray(spectrogram)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 2))
        im = ax.imshow(spectrogram, aspect="auto", origin="lower", interpolation="none")
        plt.colorbar(im, ax=ax)
        fig.canvas.draw()
        data = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
        data = data.reshape(fig.canvas.get_width_height()[::-1] + (4,))[..., :3]
        plt.close(fig)
        return data
    except Exception:
        x = spectrogram - spectrogram.min()
        x = (255 * x / max(x.max(), 1e-9)).astype(np.uint8)
        return np.stack([x, x, x], axis=-1)


def plot_alignment_to_numpy(alignment: np.ndarray) -> np.ndarray:
    """(T_out, T_in) hard or soft alignment -> image."""
    return plot_spectrogram_to_numpy(np.asarray(alignment).T)
