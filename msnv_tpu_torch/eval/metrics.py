"""The port's own copy of the JAX package's eval/metrics.py (numpy).

Objective copy-synthesis evaluation metrics.

The reference evaluates synthesis quality exclusively by subjective MOS
panels (ref doc/paper.pdf Table 1, doc/Barbany_report.pdf Tables 4.2/4.3) —
the only objective number in the codebase is the NLL-bits training loss
(ref nn.py:66-70). This module adds the standard objective vocoder metrics
so copy-synthesis quality can be tracked without a listening panel:

- **Mel-cepstral distortion** (MCD, dB) over frame-aligned mel-cepstra,
  amplitude-invariant (c0 excluded by default).
- **F0 RMSE** (Hz) and **voiced/unvoiced error rate** from a YIN-style
  normalized-autocorrelation pitch tracker (`frame_f0`), comparable either
  waveform-vs-waveform or against the Ahocoder ground-truth lf0 track the
  model was conditioned on (`lf0_track_to_f0`; unvoiced symbol semantics
  from ref interpolate.py / dataset.py:95-97).

Everything is host-side numpy by design, like the feature front-ends
(data/mel.py): metrics run offline over generated WAVs and never touch the
device's hot path. Frame rate defaults to the model's conditioner rate
(hop=80 samples = 5 ms at 16 kHz) so metric frames line up with cond frames.
"""

from __future__ import annotations

import numpy as np

from msnv_tpu_torch.data.mel import log_mel_spectrogram

_LOG10 = np.log(10.0)
# MCD convention constant: cepstra from ln-mel, distance scaled to dB.
_MCD_K = 10.0 / _LOG10 * np.sqrt(2.0)


def _dct_ii_ortho(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) orthonormal DCT-II basis (rows = cepstral orders)."""
    j = np.arange(n_in, dtype=np.float64)
    k = np.arange(n_out, dtype=np.float64)[:, None]
    basis = np.cos(np.pi * k * (2.0 * j + 1.0) / (2.0 * n_in))
    basis *= np.sqrt(2.0 / n_in)
    basis[0] *= np.sqrt(0.5)
    return basis


def mel_cepstrum(audio: np.ndarray, sr: int = 16000, n_mfcc: int = 25,
                 n_mels: int = 40, hop: int = 80,
                 n_fft: int = 512) -> np.ndarray:
    """(n_frames, n_mfcc) mel-cepstra: DCT-II(ortho) of the ln-mel power
    spectrogram. Row 0 is the frame log-energy term (excluded from MCD by
    default so the metric is gain-invariant)."""
    logmel10 = log_mel_spectrogram(audio, sr=sr, n_mels=n_mels, hop=hop,
                                   n_fft=n_fft)            # log10 mel power
    ln_mel = logmel10 * _LOG10                             # natural log
    return ln_mel @ _dct_ii_ortho(n_mfcc, n_mels).T


def mcd(ref_audio: np.ndarray, gen_audio: np.ndarray, sr: int = 16000,
        n_mfcc: int = 25, n_mels: int = 40, hop: int = 80,
        n_fft: int = 512, exclude_c0: bool = True) -> dict:
    """Frame-aligned mel-cepstral distortion in dB.

    Copy synthesis is time-aligned by construction (the generator emits one
    sample per conditioner-frame slot, ref model.py:455), so no DTW: frames
    are compared index-to-index over the common length.
    """
    c_ref = mel_cepstrum(ref_audio, sr, n_mfcc, n_mels, hop, n_fft)
    c_gen = mel_cepstrum(gen_audio, sr, n_mfcc, n_mels, hop, n_fft)
    n = min(len(c_ref), len(c_gen))
    if n == 0:
        return {"mcd_db": float("nan"), "n_frames": 0}
    lo = 1 if exclude_c0 else 0
    diff = c_ref[:n, lo:] - c_gen[:n, lo:]
    per_frame = _MCD_K * np.sqrt((diff ** 2).sum(axis=1))
    return {"mcd_db": float(per_frame.mean()), "n_frames": int(n)}


def frame_f0(audio: np.ndarray, sr: int = 16000, hop: int = 80,
             window: int = 400, fmin: float = 50.0, fmax: float = 500.0,
             threshold: float = 0.15,
             energy_floor: float = 1e-4) -> tuple[np.ndarray, np.ndarray]:
    """YIN-style pitch track: returns (f0_hz, voiced) per frame.

    Frames are centered on sample t*hop (same alignment as stft_power /
    the conditioner tracks); one frame per hop, n_frames = len(audio)//hop.
    Cumulative-mean-normalized difference function with an absolute
    threshold + parabolic interpolation (de Cheveigné & Kawahara 2002,
    steps 1-3 + 5). Unvoiced when no normalized dip falls below
    `threshold`, or the frame RMS is under `energy_floor`.
    """
    audio = np.asarray(audio, np.float64)
    n_frames = len(audio) // hop
    if n_frames == 0:
        return (np.zeros(0), np.zeros(0, dtype=bool))
    tau_min = max(2, int(sr / fmax))
    tau_max = int(np.ceil(sr / fmin))
    span = window + tau_max                 # samples needed per frame
    pad = span // 2
    x = np.pad(audio, pad, mode="reflect")
    idx = np.arange(span)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = x[idx]                          # (n_frames, span)

    # difference function d[f, tau] = sum_{j<W} (x_j - x_{j+tau})^2,
    # evaluated for tau in [0, tau_max] (vectorized over frames per tau)
    head = frames[:, :window]
    d = np.empty((n_frames, tau_max + 1), np.float64)
    d[:, 0] = 0.0
    for tau in range(1, tau_max + 1):
        delta = head - frames[:, tau:tau + window]
        d[:, tau] = (delta * delta).sum(axis=1)

    # cumulative-mean normalization: d'[0]=1, d'[tau]=d[tau]*tau/cumsum(d)
    cum = np.cumsum(d[:, 1:], axis=1)
    cmndf = np.ones_like(d)
    taus = np.arange(1, tau_max + 1, dtype=np.float64)
    np.divide(d[:, 1:] * taus, cum, out=cmndf[:, 1:],
              where=cum > 0.0)

    # first local minimum under the absolute threshold, per frame
    seg = cmndf[:, tau_min:tau_max]
    nxt = cmndf[:, tau_min + 1:tau_max + 1]
    is_dip = (seg < threshold) & (seg <= nxt)
    has_dip = is_dip.any(axis=1)
    rms = np.sqrt((head * head).mean(axis=1))
    voiced = has_dip & (rms >= energy_floor)

    tau = np.argmax(is_dip, axis=1) + tau_min       # first dip (if any)
    rows = np.arange(n_frames)
    a = cmndf[rows, tau - 1]
    b = cmndf[rows, tau]
    c = cmndf[rows, tau + 1]
    denom = a - 2.0 * b + c
    shift = np.where(np.abs(denom) > 1e-12,
                     0.5 * (a - c) / np.where(denom == 0.0, 1.0, denom),
                     0.0)
    tau_hat = tau + np.clip(shift, -0.5, 0.5)
    f0 = np.where(voiced, sr / tau_hat, 0.0)
    return f0, voiced


def lf0_track_to_f0(lf0: np.ndarray,
                    unvoiced_threshold: float = -1e8
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Ahocoder lf0 (natural-log F0, unvoiced symbol -1e10, ref
    dataset.py:95-97 / interpolate.py) -> (f0_hz, voiced)."""
    lf0 = np.asarray(lf0, np.float64)
    voiced = lf0 > unvoiced_threshold
    f0 = np.where(voiced, np.exp(np.where(voiced, lf0, 0.0)), 0.0)
    return f0, voiced


def f0_metrics(f0_ref: np.ndarray, voiced_ref: np.ndarray,
               f0_gen: np.ndarray, voiced_gen: np.ndarray) -> dict:
    """F0 RMSE (Hz, over frames voiced in BOTH tracks) + V/UV error rate
    (fraction of frames where the voicing decisions disagree)."""
    n = min(len(f0_ref), len(f0_gen))
    f0_ref, voiced_ref = f0_ref[:n], voiced_ref[:n]
    f0_gen, voiced_gen = f0_gen[:n], voiced_gen[:n]
    both = voiced_ref & voiced_gen
    if both.any():
        err = f0_ref[both] - f0_gen[both]
        rmse = float(np.sqrt((err ** 2).mean()))
    else:
        rmse = float("nan")
    vuv = float((voiced_ref != voiced_gen).mean()) if n else float("nan")
    return {"f0_rmse_hz": rmse, "vuv_error_rate": vuv,
            "n_frames": int(n), "n_both_voiced": int(both.sum())}


def saturation_bursts(audio: np.ndarray, sr: int = 16000, win: int = 160,
                      rms_thresh: float = 0.5, clip_thresh: float = 0.99,
                      min_run_s: float = 0.05) -> dict:
    """Detect the thesis's known generation failure mode: sustained
    high-energy noise bursts, sometimes ~9,500 samples (~0.6 s) long
    (ref doc/Barbany_report.pdf §4.3, fig 4.1 via SURVEY.md §6).

    Energy-run-length metric: windowed RMS (win samples, hop = win); a
    *burst* is a run of >= min_run_s seconds of consecutive windows whose
    RMS exceeds rms_thresh (natural speech peaks that high only
    transiently — a µ-law saturation burst pins near full scale for
    hundreds of ms). Also reports the clipped-sample fraction
    (|x| >= clip_thresh), the steady-state symptom.

    Returns {"burst_fraction": fraction of audio inside bursts,
             "n_bursts", "longest_burst_s", "clip_fraction"}. All zeros on
    healthy audio — tracked per epoch so a run that starts saturating is
    visible in the stats, not just audible.
    """
    audio = np.asarray(audio, np.float64).reshape(-1)
    n_win = len(audio) // win
    out = {"burst_fraction": 0.0, "n_bursts": 0, "longest_burst_s": 0.0,
           "clip_fraction": 0.0}
    if n_win == 0:
        return out
    out["clip_fraction"] = float(
        (np.abs(audio) >= clip_thresh).mean())
    x = audio[:n_win * win].reshape(n_win, win)
    rms = np.sqrt((x ** 2).mean(axis=1))
    hot = rms > rms_thresh
    min_run = max(1, int(round(min_run_s * sr / win)))
    # run lengths of consecutive hot windows
    edges = np.flatnonzero(np.diff(np.concatenate(([0], hot.view(np.int8),
                                                   [0]))))
    starts, ends = edges[::2], edges[1::2]
    runs = ends - starts
    bursts = runs[runs >= min_run]
    if len(bursts):
        out["n_bursts"] = int(len(bursts))
        out["burst_fraction"] = float(bursts.sum() * win / len(audio))
        out["longest_burst_s"] = float(bursts.max() * win / sr)
    return out


def evaluate_pair(ref_audio: np.ndarray, gen_audio: np.ndarray,
                  sr: int = 16000, hop: int = 80, n_mfcc: int = 25,
                  **f0_kwargs) -> dict:
    """All metrics for one (reference, generated) waveform pair.

    Frame counts are reported per metric family (`n_frames_mcd` vs
    `n_frames_f0`) — the cepstral and pitch tracks can frame different
    common lengths.
    """
    out = mcd(ref_audio, gen_audio, sr=sr, hop=hop, n_mfcc=n_mfcc)
    out["n_frames_mcd"] = out.pop("n_frames")
    fr, vr = frame_f0(ref_audio, sr=sr, hop=hop, **f0_kwargs)
    fg, vg = frame_f0(gen_audio, sr=sr, hop=hop, **f0_kwargs)
    fo = f0_metrics(fr, vr, fg, vg)
    fo["n_frames_f0"] = fo.pop("n_frames")
    out.update(fo)
    # generated-audio-only health metric (the reference recording is
    # assumed saturation-free)
    out.update(saturation_bursts(gen_audio, sr=sr))
    return out
