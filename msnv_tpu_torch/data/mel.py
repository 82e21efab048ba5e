"""The port's own copy of the JAX package's data/mel.py (numpy).

Ahocoder-free conditioning: log-mel-spectrogram front-end.

The reference conditions exclusively on Ahocoder features (.cc/.lf0/.gv
text tracks, ref dataset.py:89-104) — Ahocoder is an external Windows/Linux
binary most corpora don't ship with. This adapter derives the per-frame
conditioner track directly from the waveform, so ANY 16 kHz multi-speaker
corpus can train the vocoder: cond_source="mel" in CorpusConfig swaps the
Ahocoder loader for `log_mel_spectrogram` with hop == cond_len (one
conditioner frame per 80-sample/5 ms hop, exactly the model's frame rate).

Feature extraction is host-side numpy by design: like the reference's
Ahocoder step it runs once, offline, into the npy cache — the device
never sees it. Filterbank is HTK-mel (2595*log10(1+f/700)), triangular filters,
Hann-windowed reflect-centered STFT; log is log10 with a -10 dB floor.
Downstream (min/max normalization, look-ahead doubling, packing) is shared
with the Ahocoder path unchanged.
"""

from __future__ import annotations

import numpy as np

LOG_FLOOR = 1e-10


def hz_to_mel(f):
    """HTK mel scale."""
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None) -> np.ndarray:
    """(n_mels, n_fft//2 + 1) triangular HTK-mel filterbank."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)                       # (n_mels + 2,)
    fb = np.zeros((n_mels, n_bins), np.float64)
    for i in range(n_mels):
        left, center, right = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (fft_freqs - left) / max(center - left, 1e-12)
        down = (right - fft_freqs) / max(right - center, 1e-12)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    return fb


def stft_power(audio: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """Power spectrogram, reflect-centered Hann STFT.

    Frame t is centered on sample t*hop; returns
    (1 + len(audio)//hop, n_fft//2 + 1).
    """
    audio = np.asarray(audio, np.float64)
    pad = n_fft // 2
    x = np.pad(audio, pad, mode="reflect")
    n_frames = 1 + len(audio) // hop
    win = np.hanning(n_fft + 1)[:-1]                  # periodic Hann
    idx = (np.arange(n_fft)[None, :]
           + hop * np.arange(n_frames)[:, None])      # (n_frames, n_fft)
    frames = x[idx] * win
    spec = np.fft.rfft(frames, axis=-1)
    return (spec.real ** 2 + spec.imag ** 2)


def log_mel_spectrogram(audio: np.ndarray, sr: int = 16000,
                        n_mels: int = 43, hop: int = 80,
                        n_fft: int = 512, fmin: float = 0.0,
                        fmax: float | None = None) -> np.ndarray:
    """(len(audio)//hop, n_mels) log10 mel-power track.

    Emits exactly one frame per `hop` samples (frame f covers samples
    [f*hop, (f+1)*hop) — same alignment contract as the Ahocoder tracks),
    so the corpus packing math is identical for both cond sources.
    """
    n_frames = len(audio) // hop
    power = stft_power(audio, n_fft, hop)[:n_frames]  # (n_frames, bins)
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    mel = power @ fb.T
    return np.log10(np.maximum(mel, LOG_FLOOR))


def mel_cond_track(audio: np.ndarray, cond_dim: int,
                   cond_len: int) -> np.ndarray:
    """Corpus-facing adapter: audio (already length-synced to a multiple of
    cond_len) -> (len(audio)//cond_len, cond_dim) float64 conditioners."""
    return log_mel_spectrogram(audio, n_mels=cond_dim, hop=cond_len)
