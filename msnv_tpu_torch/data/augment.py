"""Waveform augmentation for small-corpus training — pure numpy.

The port's own copy of the JAX package's data/augment.py (same functions,
same output bit for bit); WAVs are read and written by the port's
data/wavio.py.

The reference has no augmentation subsystem (its TC-STAR corpus is
5.25 h); this module exists for the small-data regime the real-speech
study exposed (docs/REAL_SPEECH.md: 127 s of audio under-feeds every
model width). Standard speech recipe (Kaldi/sox "speed perturbation"):
resample each utterance by factors around 1.0 — pitch and duration
shift together, so a 3-way perturb triples the corpus with acoustically
consistent variants — plus optional gain perturbation (µ-law
quantization is amplitude-sensitive).

Everything is per-utterance numpy: a windowed-sinc lowpass applied via
FFT convolution (utterances are ~10^5 samples, so one rfft round-trip
per utterance is cheap); no scipy/librosa dependency, same policy as
data/wavio.py.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np


def _fft_convolve(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Full linear convolution via one rfft round trip (f64 accumulate)."""
    n = len(x) + len(h) - 1
    size = 1 << (n - 1).bit_length()
    y = np.fft.irfft(np.fft.rfft(x, size) * np.fft.rfft(h, size), size)
    return y[:n]


def resample_rational(x: np.ndarray, p: int, q: int,
                      taps: int = 32, beta: float = 8.6) -> np.ndarray:
    """y[i] ~= x(i * p / q): upsample by q (zero stuffing), Kaiser-windowed
    sinc lowpass at the tighter of the two Nyquist limits, decimate by p.

    `taps` is the sinc half-width in ORIGINAL samples (32 gives ~80 dB
    stopband with the 8.6 Kaiser); the filter runs at the upsampled rate
    so its length scales with q.
    """
    if p == q:
        return np.asarray(x, np.float32)
    x = np.asarray(x, np.float64)
    cutoff = 1.0 / max(p, q)             # of the upsampled Nyquist
    half = taps * max(p, q)
    k = np.arange(-half, half + 1, dtype=np.float64)
    h = cutoff * np.sinc(cutoff * k) * np.kaiser(2 * half + 1, beta)
    up = np.zeros(len(x) * q)
    up[::q] = x
    y = _fft_convolve(up, h * q)[half:half + len(up)]
    return y[::p].astype(np.float32)


def speed_perturb(audio: np.ndarray, factor: float,
                  max_den: int = 20) -> np.ndarray:
    """sox-style speed perturbation: duration /= factor, pitch *= factor.

    `factor` is snapped to a rational with denominator <= max_den (0.9
    and 1.1 are exact); output amplitude is clipped to [-1, 1) so the
    downstream µ-law quantizer sees the same domain as the source.

    max_den caps the zero-stuffed intermediate at `q` times the
    utterance (resample_rational works at the upsampled rate): the old
    default of 100 made factor=0.97 build a 100x float64 array plus
    power-of-two FFT buffers — multi-GB transients on minute-long
    utterances. 20 keeps the transient <~160 MB/min of audio; every
    multiple of 0.05 (the usual perturbation grid) is exact, other
    factors snap to the nearest den<=20 rational (up to ~2% off, e.g.
    0.97 -> 19/20) — pass a larger max_den explicitly if an off-grid
    factor must be exact and the utterances are short.
    """
    if factor <= 0:
        raise ValueError(f"speed factor must be > 0, got {factor}")
    frac = Fraction(factor).limit_denominator(max_den)
    snapped = frac.numerator / frac.denominator
    if abs(snapped - factor) > 1e-6 * max(1.0, abs(factor)):
        # off-grid factor: warn instead of silently shifting pitch/
        # duration by up to ~2% (0.97 at max_den=20 resamples at 19/20)
        import warnings
        warnings.warn(
            f"speed factor {factor} snapped to {frac.numerator}/"
            f"{frac.denominator} = {snapped:.6g} (max_den={max_den}); "
            f"pass a larger max_den if the exact ratio matters "
            f"(costs a {frac.denominator}x resampling intermediate)",
            stacklevel=2)
    y = resample_rational(audio, frac.numerator, frac.denominator)
    return np.clip(y, -1.0, np.float32(32767 / 32768))


def gain_perturb(audio: np.ndarray, gain: float) -> np.ndarray:
    """Scale amplitude; clipped to the PCM16 domain like speed_perturb."""
    return np.clip(np.asarray(audio, np.float32) * np.float32(gain),
                   -1.0, np.float32(32767 / 32768))


def augment_corpus(data_dir: str, speeds=(0.9, 1.1), gains=(),
                   subdir: str = "wav", list_name: str = "wav_train.list",
                   read_wav=None, write_wav=None) -> list:
    """Stage augmented variants of every train-list utterance in place.

    For each utterance `<name>` in `<data_dir>/<list_name>`, writes
    `<name>s<speed*100>` / `<name>g<gain*100>` WAVs next to the sources
    (the corpus convention only fixes the 2-char speaker prefix —
    ref dataset.py:73-76 — so suffixed names stay valid) and rewrites
    the train list with the originals followed by the variants,
    round-robin across speakers (lane packing truncates the TAIL of the
    concatenated stream, so a variant-blocked list would drop whole
    speakers — same rationale as scripts/real_speech_run.py staging).
    Validation/test lists are untouched. Idempotent: already-augmented
    names (containing an `s`/`g` suffix tag) are never re-augmented, and
    the list is rebuilt from the surviving originals. Returns the new
    train list.
    """
    import os

    if read_wav is None or write_wav is None:
        from msnv_tpu_torch.data.wavio import read_wav as _r
        from msnv_tpu_torch.data.wavio import write_wav as _w
        read_wav = read_wav or _r
        write_wav = write_wav or _w
    import re

    list_path = os.path.join(data_dir, list_name)
    with open(list_path) as f:
        names = [ln.strip() for ln in f if ln.strip()]
    # an original is any name WITHOUT a variant tag — match the tag
    # grammar itself ([sg] + 3 digits at the end), not just the current
    # run's tag set, so rerunning with different speeds/gains never
    # treats a prior run's variants (e.g. '72u000s090') as originals and
    # compounds variant-of-variant WAVs into the list
    originals = [n for n in names if not re.search(r"[sg]\d{3}$", n)]
    # names matching the variant grammar are skipped as prior-run
    # variants; a GENUINE original whose id happens to end in s/g+3
    # digits would be silently excluded from augmentation AND from the
    # rebuilt list. Such a name is distinguishable: its stem (the name
    # minus the 4-char tag) has no corresponding original in the list.
    orphans = [n for n in names
               if re.search(r"[sg]\d{3}$", n) and n[:-4] not in originals]
    if orphans:
        import warnings
        warnings.warn(
            f"{len(orphans)} train-list name(s) match the augmentation "
            f"tag grammar ([sg]NNN suffix) but have no corresponding "
            f"original in the list (e.g. {orphans[0]!r}); treating them "
            f"as stale variants and DROPPING them from the rebuilt list "
            f"— rename genuine originals to avoid the suffix grammar",
            stacklevel=2)
    wav_dir = os.path.join(data_dir, subdir)
    variants = {n: [] for n in originals}
    for name in originals:
        audio, sr = read_wav(os.path.join(wav_dir, name + ".wav"))
        for s in speeds:
            vn = f"{name}s{int(round(s * 100)):03d}"
            write_wav(os.path.join(wav_dir, vn + ".wav"),
                      speed_perturb(audio, s), sr)
            variants[name].append(vn)
        for g in gains:
            vn = f"{name}g{int(round(g * 100)):03d}"
            write_wav(os.path.join(wav_dir, vn + ".wav"),
                      gain_perturb(audio, g), sr)
            variants[name].append(vn)
    # originals first (round-robin order preserved from the source list),
    # then variant rank 0 of every utterance, then rank 1, ...
    out = list(originals)
    rank = 0
    while any(rank < len(v) for v in variants.values()):
        for name in originals:
            if rank < len(variants[name]):
                out.append(variants[name][rank])
        rank += 1
    with open(list_path, "w") as f:
        f.write("\n".join(out) + "\n")
    return out
