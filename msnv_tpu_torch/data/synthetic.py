"""The port's own copy of the JAX package's data/synthetic.py (numpy).

Synthetic fixture corpora for tests and benchmarks.

The TC-STAR corpus is private (the reference repo ships only dangling
symlinks under tcstar/), so tests build a miniature corpus with the same
on-disk structure: WAV files plus Ahocoder-style .cc/.lf0/.gv text files and
wav_<partition>.list partition lists (ref tcstar/*.list, dataset.py:66-107).
"""

from __future__ import annotations

import os

import numpy as np

from msnv_tpu_torch.data.wavio import write_wav
from msnv_tpu_torch.data.corpus import F0_UNVOICED, GV_UNVOICED


def make_synthetic_corpus(root, n_speakers=2, utts_per_speaker=3,
                          frames_per_utt=64, cond_len=80, n_cc=40,
                          sample_rate=16000, seed=0, partitions=("train",),
                          uneven_lengths=True, interleave=False):
    """Create a fixture corpus under `root`.

    Layout:
      root/wav/<spk><utt>.wav
      root/cond/<spk><utt>.{cc,lf0,gv}
      root/wav_<partition>.list

    Speaker names are 2-digit prefixes ('71', '72', ...) matching the
    reference's first-2-chars speaker-id convention (ref dataset.py:73-76).
    Returns (wav_dir, cond_dir, list of utterance names).
    """
    rng = np.random.RandomState(seed)
    wav_dir = os.path.join(root, "wav")
    cond_dir = os.path.join(root, "cond")
    os.makedirs(wav_dir, exist_ok=True)
    os.makedirs(cond_dir, exist_ok=True)

    names = []
    for s in range(n_speakers):
        spk = f"{71 + s}"
        f_base = 100.0 + 40.0 * s
        for u in range(utts_per_speaker):
            name = f"{spk}u{u:03d}"
            names.append(name)
            nf = frames_per_utt + (rng.randint(-4, 5) if uneven_lengths else 0)
            n_samp = nf * cond_len
            extra = 0
            if uneven_lengths:
                # a partial final frame, like Ahocoder output: audio has
                # nf*cond_len + extra samples (0 <= extra < cond_len) and the
                # cond tracks cover ceil(samples/cond_len) frames. Exercises
                # the oversize sync logic (ref dataset.py:113-124); values
                # chosen to hit both pad (>=60) and truncate branches while
                # avoiding the reference's oversize==60 double-branch bug.
                extra = int(rng.choice([0, 7, min(cond_len - 1, 30),
                                        min(cond_len - 1, 75)]))
                n_samp += extra
            nf_cond = nf + (1 if extra > 0 else 0)
            t = np.arange(n_samp) / sample_rate
            f0 = f_base * (1.0 + 0.1 * np.sin(2 * np.pi * 0.7 * t))
            audio = 0.4 * np.sin(2 * np.pi * np.cumsum(f0) / sample_rate)
            audio += 0.05 * rng.randn(n_samp)
            audio = np.clip(audio, -0.999, 0.999).astype(np.float32)
            write_wav(os.path.join(wav_dir, name + ".wav"), audio, sample_rate)

            cc = rng.randn(nf_cond, n_cc) * 0.5 + s
            np.savetxt(os.path.join(cond_dir, name + ".cc"), cc)

            lf0 = np.log(f_base) + 0.1 * rng.randn(nf_cond)
            voiced = rng.rand(nf_cond) > 0.3
            lf0_track = np.where(voiced, lf0, F0_UNVOICED * 2)
            np.savetxt(os.path.join(cond_dir, name + ".lf0"), lf0_track)

            gv = np.where(voiced, 4000.0 + 500 * rng.randn(nf_cond),
                          GV_UNVOICED / 2)
            np.savetxt(os.path.join(cond_dir, name + ".gv"), gv)

    if interleave:
        # round-robin the speakers so batch-major lane packing (which
        # truncates the corpus tail) never drops a whole speaker — the
        # layout per-speaker (norm_ind) normalization needs
        chunks = [names[s * utts_per_speaker:(s + 1) * utts_per_speaker]
                  for s in range(n_speakers)]
        names = [n for group in zip(*chunks) for n in group]
    for part in partitions:
        with open(os.path.join(root, f"wav_{part}.list"), "w") as fh:
            fh.write("\n".join(names) + "\n")
    return wav_dir, cond_dir, names


# ---- speech-like pretraining corpus -----------------------------------
#
# The tonal fixture above is fine for shape/parity tests but carries no
# speech structure. For TRANSFER LEARNING (pretrain on unlimited
# synthetic audio, fine-tune on a small real corpus — VERDICT r03 item 2)
# the pretraining distribution needs speech-like statistics: pitch
# contours, formant envelopes, voiced/unvoiced alternation, syllabic
# amplitude modulation. This is a crude numpy source-filter synthesizer:
# a sawtooth glottal source with per-speaker F0 (vibrato + jitter +
# declination), filtered per "syllable" by 3 vowel formant bumps
# (frequency-domain, segment-wise), interleaved with fricative-like
# shaped-noise bursts and silences. Per-speaker identity = F0 base +
# vocal-tract length factor scaling all formants + spectral tilt.

_VOWELS = (          # (F1, F2, F3) Hz — rough Spanish-ish vowel space
    (700.0, 1200.0, 2600.0),   # a
    (400.0, 2000.0, 2800.0),   # e
    (300.0, 2300.0, 3000.0),   # i
    (450.0, 800.0, 2600.0),    # o
    (325.0, 700.0, 2530.0),    # u
)


def _formant_filter(x, sr, formants, tilt_db_oct=-6.0, bw=90.0):
    """Shape a segment's spectrum with Gaussian formant bumps + tilt."""
    n = len(x)
    spec = np.fft.rfft(x)
    f = np.fft.rfftfreq(n, 1.0 / sr)
    env = np.zeros_like(f)
    for k, fk in enumerate(formants):
        amp = 10.0 ** (-3.0 * k / 20.0)        # higher formants weaker
        env += amp * np.exp(-0.5 * ((f - fk) / (bw * (1 + k))) ** 2)
    env += 0.03                                 # skirt
    env *= 10.0 ** (tilt_db_oct / 20.0 * np.log2(np.maximum(f, 60.0) / 60.0))
    return np.fft.irfft(spec * env, n)


def _voiced_segment(rng, sr, dur_s, f0_base, formants, tilt):
    n = int(dur_s * sr)
    t = np.arange(n) / sr
    f0 = f0_base * (1.0
                    - 0.10 * t / max(dur_s, 1e-6)          # declination
                    + 0.02 * np.sin(2 * np.pi * 5.5 * t)   # vibrato
                    + 0.01 * rng.randn(n).cumsum() / np.sqrt(np.arange(1, n + 1)))
    phase = np.cumsum(f0) / sr
    saw = 2.0 * (phase % 1.0) - 1.0             # harmonic-rich source
    saw += 0.02 * rng.randn(n)                  # aspiration
    y = _formant_filter(saw, sr, formants, tilt)
    # syllabic attack/decay
    a = min(int(0.02 * sr), n // 3)
    envl = np.ones(n)
    envl[:a] = np.linspace(0, 1, a)
    envl[-a:] = np.linspace(1, 0, a)
    return y * envl


def _unvoiced_segment(rng, sr, dur_s, center_hz, tilt):
    n = int(dur_s * sr)
    y = _formant_filter(rng.randn(n), sr, (center_hz,), tilt, bw=600.0)
    a = min(int(0.008 * sr), max(n // 3, 1))
    envl = np.ones(n)
    envl[:a] = np.linspace(0, 1, a)
    envl[-a:] = np.linspace(1, 0, a)
    return y * envl


def speechlike_utterance(rng, sr=16000, seconds=6.0, f0_base=140.0,
                         vtl=1.0, tilt_db_oct=-6.0):
    """One speech-like utterance: syllable train of vowel + optional
    fricative + gap. `vtl` scales all formants (vocal-tract length)."""
    parts = []
    total = 0
    target = int(seconds * sr)
    while total < target:
        v = _VOWELS[rng.randint(len(_VOWELS))]
        formants = tuple(fk * vtl for fk in v)
        f0 = f0_base * (1.0 + 0.15 * rng.randn())
        seg = _voiced_segment(rng, sr, rng.uniform(0.08, 0.3),
                              max(f0, 60.0), formants, tilt_db_oct)
        parts.append(seg)
        total += len(seg)
        if rng.rand() < 0.45:
            fric = _unvoiced_segment(rng, sr, rng.uniform(0.04, 0.12),
                                     rng.uniform(2500, 6000) * vtl,
                                     tilt_db_oct)
            parts.append(0.4 * fric)
            total += len(fric)
        gap = np.zeros(int(rng.uniform(0.01, 0.08) * sr))
        parts.append(gap)
        total += len(gap)
    y = np.concatenate(parts)[:target]
    peak = np.abs(y).max()
    return (0.5 * y / max(peak, 1e-6)).astype(np.float32)


def make_speechlike_corpus(root, n_speakers=6, utts_per_speaker=8,
                           seconds_per_utt=6.0, sample_rate=16000,
                           seed=0, spk_names=None):
    """Speech-like multi-speaker pretraining corpus under `root`/wav,
    with a round-robin wav_train.list (lane packing truncates the stream
    TAIL, so speaker-blocked lists would drop whole speakers).

    Per-speaker identity: F0 base spread over ~100-240 Hz, vocal-tract
    factor 0.86-1.14, spectral tilt -8..-4 dB/oct. Returns
    (wav_dir, names). Mel conditioning reads the WAVs directly, so no
    .cc/.lf0/.gv files are needed.
    """
    rng = np.random.RandomState(seed)
    wav_dir = os.path.join(root, "wav")
    os.makedirs(wav_dir, exist_ok=True)
    if spk_names is None:
        spk_names = [f"{71 + s}" for s in range(n_speakers)]
    assert len(spk_names) == n_speakers
    per_spk = []
    for s, spk in enumerate(spk_names):
        u = s / max(n_speakers - 1, 1)
        f0_base = 100.0 + 140.0 * u
        vtl = 1.14 - 0.28 * u
        tilt = -8.0 + 4.0 * u
        names = []
        for k in range(utts_per_speaker):
            name = f"{spk}u{k:03d}"
            audio = speechlike_utterance(
                rng, sr=sample_rate, seconds=seconds_per_utt,
                f0_base=f0_base, vtl=vtl, tilt_db_oct=tilt)
            write_wav(os.path.join(wav_dir, name + ".wav"), audio,
                      sample_rate)
            names.append(name)
        per_spk.append(names)
    names = [n for group in zip(*per_spk) for n in group]  # round-robin
    with open(os.path.join(root, "wav_train.list"), "w") as fh:
        fh.write("\n".join(names) + "\n")
    return wav_dir, names
