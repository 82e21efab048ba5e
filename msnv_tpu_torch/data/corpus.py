"""The port's own copy of the JAX package's data/corpus.py (numpy). The
cache layout and file names are the same, so each package reads the other's
`npy_datasets/`. Under torch.distributed, rank 0 builds or loads and the
other ranks load after a barrier (`build_corpus`).

Corpus build: WAV + Ahocoder features -> packed batch-major lane streams.

Reproduces the reference's offline pipeline (ref dataset.py:13-236) with the
same on-disk cache layout under `npy_datasets/`:

  npy_datasets/spk_id[_static].npy
  npy_datasets/min_max_{ind|joint}[_static].npy
  npy_datasets/<partition>/{data,conditioners_*,speakers,audio_id}[_static].npy
  npy_datasets/<partition>/conditioners_*_ahead.npy   (look-ahead cache)

Pipeline per utterance (ref dataset.py:83-141):
  wav (float32) ‖ .cc (40 MFCC) ‖ interpolated .lf0 ‖ interpolated .gv + U/V
  -> sync audio length to cond_len * n_frames -> 43-dim cond track.

Packing (ref dataset.py:143-163): the whole corpus is one flat stream,
truncated to a multiple of batch_size*(seq_len+overlap)*cond_len and reshaped
so each of the `batch_size` rows ("lanes") is one long contiguous audio
stream — the TBPTT layout where consecutive chunk batches advance every lane
by seq_len with hidden-state carry.

Documented deviations from the reference (each is a bug fix, see
tests/test_corpus.py):
- oversize == 60 exactly: the reference both pads AND truncates (two
  non-exclusive ifs, ref dataset.py:113-124), desynchronizing audio/cond for
  the rest of the corpus. We make the branches exclusive (pad if >= 60 else
  truncate).
- window count: the reference's `length = total_samples // seq_len` can
  overrun lane ends for some corpus sizes (last window needs seq_len +
  overlap samples); we only emit full windows.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from msnv_tpu_torch.ops.interpolate import interpolation

F0_UNVOICED = -1e10   # ref dataset.py:96
GV_UNVOICED = 1e3     # ref dataset.py:101


@dataclass(frozen=True)
class CorpusConfig:
    datasets_path: str          # dir with wav_<partition>.list files
    wav_path: str               # dir with <utt>.wav
    cond_path: str              # dir with <utt>.{cc,lf0,gv}
    overlap_len: int = 80       # model lookback
    q_levels: int = 256
    ulaw: bool = True
    seq_len: int = 1040
    batch_size: int = 128
    cond_dim: int = 43
    cond_len: int = 80
    norm_ind: bool = True
    static_spk: bool = False
    look_ahead: bool = False
    cache_dir: str = "npy_datasets"
    # "ahocoder" (reference .cc/.lf0/.gv tracks) or "mel" (Ahocoder-free
    # log-mel front-end, data/mel.py — cond_dim = n_mels)
    cond_source: str = "ahocoder"


@dataclass
class Corpus:
    """Packed batch-major corpus for one partition."""
    data: np.ndarray        # (B, lane_len) float32 audio (ulaw) or int (linear)
    cond: np.ndarray        # (B, lane_frames, cond_dim[*2 if look_ahead])
    spk: np.ndarray         # (B, lane_frames) int speaker ids
    audio_id: np.ndarray    # (B, lane_frames) int utterance ids
    min_cond: np.ndarray
    max_cond: np.ndarray
    spk_ids: np.ndarray     # unique speaker name prefixes, sorted


def _names(cfg: CorpusConfig, partition: str):
    st = "_static" if cfg.static_spk else ""
    if cfg.cond_source != "ahocoder":
        # mel caches must never alias the Ahocoder caches
        st = f"_{cfg.cond_source}{st}"
    norm = "_ind" if cfg.norm_ind else "_joint"
    d = os.path.join(cfg.cache_dir, partition)
    return {
        "data": os.path.join(d, f"data{st}.npy"),
        "cond": os.path.join(d, f"conditioners{norm}{st}.npy"),
        "spk": os.path.join(d, f"speakers{st}.npy"),
        "audio_id": os.path.join(d, f"audio_id{st}.npy"),
        "min_max": os.path.join(cfg.cache_dir, f"min_max{norm}{st}.npy"),
        "spk_id": os.path.join(cfg.cache_dir, f"spk_id{st}.npy"),
    }


def load_cond_tracks(cond_path: str, name: str):
    """Load + interpolate one utterance's Ahocoder tracks.

    Returns (cc (n,40), f0 (n,1), fv (n,1), uv (n,1)) — shared by the
    corpus build and the generation CLI (ref dataset.py:89-104,
    generate.py:158-171). Uses the native parser when built; guards the
    single-line case (np.loadtxt would return 0-d).
    """
    from msnv_tpu_torch.data import native
    c = np.atleast_1d(native.loadtxt(os.path.join(cond_path, name + ".cc")))
    c = c.reshape(-1, c.shape[-1]) if c.ndim > 1 else c.reshape(1, -1)
    f0_raw = np.atleast_1d(
        native.loadtxt(os.path.join(cond_path, name + ".lf0")))
    f0, _ = interpolation(f0_raw, F0_UNVOICED)
    f0 = np.asarray(f0).reshape(-1, 1)
    gv_raw = np.atleast_1d(
        native.loadtxt(os.path.join(cond_path, name + ".gv")))
    fv, uv = interpolation(gv_raw, GV_UNVOICED)
    fv = np.asarray(fv).reshape(-1, 1)
    uv = np.asarray(uv).reshape(-1, 1)
    return c, f0, fv, uv


def load_utterance(cfg: CorpusConfig, name: str):
    """Load one utterance: returns (audio, cond(43), n_frames_label).

    ref dataset.py:83-135. Sync deviation for oversize==60 documented in the
    module docstring.

    Reproduced reference quirk: `n_frames_label` (the repeat count for the
    speaker/audio-id tracks) is the PRE-truncation frame count — the
    reference builds those tracks (ref dataset.py:107-111) before the sync
    block trims the cond tracks (ref dataset.py:119-124) and never trims
    them, so speaker labels drift +1 frame per truncated utterance relative
    to the conditioners. Reproduced for exact data parity
    (tests/test_dataset_parity.py); the drift slightly blurs per-speaker
    normalization masks and majority-speaker labels at utterance
    boundaries, identically to the reference.
    """
    from msnv_tpu_torch.data import native
    d, _sr = native.read_wav(os.path.join(cfg.wav_path, name + ".wav"))
    # clamp strictly below +1.0: float-format WAVs can carry samples at or
    # above full scale, and uquantize maps f32 values within ~1 ulp of 1.0
    # to the out-of-range level q (the reference's utils.py:48-51 overflow
    # quirk) — which would silently train on clamped-wrong targets. This is
    # the "packer clamps upstream" contract in ops/quantize.py.
    d = np.minimum(np.maximum(d, -1.0), 1.0 - 1e-5)

    if cfg.cond_source == "mel":
        # Ahocoder-free path: sync the audio first (same pad/truncate rule),
        # then derive conditioners from the waveform itself — one log-mel
        # frame per cond_len samples (data/mel.py). No label-drift
        # quirk here: there is no pre-truncation track to miscount.
        from msnv_tpu_torch.data.mel import mel_cond_track
        oversize = d.shape[0] % cfg.cond_len
        if oversize >= 60:
            d = np.append(d, np.zeros(cfg.cond_len - oversize, dtype=d.dtype))
        elif oversize != 0:
            d = d[:-oversize]
        cond = mel_cond_track(d, cfg.cond_dim, cfg.cond_len)
        return d, cond, cond.shape[0]

    c, f0, fv, uv = load_cond_tracks(cfg.cond_path, name)

    n_frames_label = fv.shape[0]  # pre-truncation count (quirk, see above)

    # length sync (ref dataset.py:113-124; exclusive-branch deviation)
    oversize = d.shape[0] % cfg.cond_len
    if oversize >= 60:
        d = np.append(d, np.zeros(cfg.cond_len - oversize, dtype=d.dtype))
    elif oversize != 0:
        d = d[:-oversize]
        c = c[:-1]
        f0, fv, uv = f0[:-1], fv[:-1], uv[:-1]

    n = min(c.shape[0], f0.shape[0], fv.shape[0])
    cond = np.concatenate(
        [c[:n], f0[:n], fv[:n], uv[:n].astype(np.float64)], axis=1)
    return d, cond, n_frames_label


def build_corpus(cfg: CorpusConfig, partition: str,
                 use_cache: bool = True) -> Corpus:
    """Build (or load from cache) the packed corpus for a partition.

    Multi-process safe: the npy caches live on a shared filesystem, so when
    several ranks of a torch.distributed process group enter with a cold
    cache, rank 0 builds (writes) alone and a barrier fences the rest,
    which then load the finished caches — never torn concurrent np.save's
    of the same files.
    """
    from msnv_tpu_torch.parallel.mesh import (barrier, is_main_process,
                                              world_size)
    names = _names(cfg, partition)

    def _cached():
        return all(os.path.isfile(names[k])
                   for k in ("data", "cond", "spk", "min_max"))

    if world_size() > 1:
        # the barrier must be UNCONDITIONAL per call: deciding it from the
        # cache state races (rank 0 can finish building before another
        # rank first probes the cache, leaving them at different
        # barriers). Every rank passes exactly one per partition, also
        # when rank 0's build raises: the others then fail to load.
        corpus = None
        try:
            if is_main_process():
                corpus = (load_corpus(cfg, partition)
                          if _cached() and use_cache
                          else _build_corpus_local(cfg, partition, names))
        finally:
            barrier()
        return corpus if corpus is not None else load_corpus(cfg, partition)

    if _cached() and use_cache:
        return load_corpus(cfg, partition)
    return _build_corpus_local(cfg, partition, names)


def _build_corpus_local(cfg: CorpusConfig, partition: str, names) -> Corpus:
    """The corpus build of one process (the cache writer)."""

    os.makedirs(os.path.dirname(names["data"]), exist_ok=True)

    st = "_static" if cfg.static_spk else ""
    list_path = os.path.join(cfg.datasets_path, f"wav_{partition}{st}.list")
    with open(list_path) as fh:
        file_names = fh.read().splitlines()

    # speaker table: sorted unique 2-char prefixes (ref dataset.py:69-80)
    if os.path.isfile(names["spk_id"]):
        spk_ids = np.load(names["spk_id"])
    else:
        spk_ids = np.asarray(sorted({f[0:2] for f in file_names}))
        np.save(names["spk_id"], spk_ids)

    datas, conds, spks, audio_ids = [], [], [], []
    for counter, fname in enumerate(file_names):
        d, cond, n_frames = load_utterance(cfg, fname)
        speaker = int(np.where(spk_ids == fname[0:2])[0][0])
        if not cfg.ulaw:
            # linear path quantizes per-utterance at build time
            # (ref dataset.py:129-130)
            import torch
            from msnv_tpu_torch.ops.quantize import linear_quantize
            d = linear_quantize(torch.from_numpy(d.astype(np.float32)),
                                cfg.q_levels).numpy()
        datas.append(d)
        conds.append(cond)
        spks.append(np.full(n_frames, speaker, dtype=np.int64))
        audio_ids.append(np.full(n_frames, counter, dtype=np.int64))

    data = np.concatenate(datas)
    cond = np.concatenate(conds, axis=0)
    spk = np.concatenate(spks)
    audio_id = np.concatenate(audio_ids)

    # packing (ref dataset.py:143-163)
    total_samples = data.shape[0]
    dim_cond = cond.shape[1]
    lon_seq = cfg.seq_len + cfg.overlap_len
    num_samples = cfg.batch_size * (
        total_samples // (cfg.batch_size * lon_seq * cfg.cond_len))
    if num_samples == 0:
        raise ValueError(
            f"corpus too small: {total_samples} samples < "
            f"{cfg.batch_size * lon_seq * cfg.cond_len} required")
    total = num_samples * lon_seq * cfg.cond_len
    total_cond = total // cfg.cond_len
    data = data[:total].reshape(cfg.batch_size, -1)
    cond = cond[:total_cond].reshape(cfg.batch_size, -1, dim_cond)
    spk = spk[:total_cond].reshape(cfg.batch_size, -1)
    audio_id = audio_id[:total_cond].reshape(cfg.batch_size, -1)

    # conditioner min/max from the train partition (ref dataset.py:166-186)
    if partition == "train" and not os.path.isfile(names["min_max"]):
        if cfg.norm_ind:
            num_spk = len(spk_ids)
            max_cond = np.empty((num_spk, dim_cond))
            min_cond = np.empty((num_spk, dim_cond))
            for i in range(num_spk):
                sel = cond[spk == i]
                if sel.shape[0] == 0:
                    # the packing truncation (reference formula) dropped
                    # every frame of this speaker — the reference crashes
                    # here with an opaque numpy reduction error
                    raise ValueError(
                        f"norm_ind: speaker {spk_ids[i]!r} has no frames "
                        f"left after packing truncation (corpus "
                        f"{total_samples} samples truncated to {total}). "
                        f"Interleave speakers in the wav list, add data, "
                        f"or use norm_ind=false.")
                max_cond[i] = np.amax(sel, axis=0)
                min_cond[i] = np.amin(sel, axis=0)
        else:
            max_cond = np.amax(np.amax(cond, axis=1), axis=0)
            min_cond = np.amin(np.amin(cond, axis=1), axis=0)
        np.save(names["min_max"], np.array([min_cond, max_cond]))
    else:
        mm = np.load(names["min_max"])
        min_cond, max_cond = mm[0], mm[1]

    # normalize to [0, 1] (ref dataset.py:188-198)
    if cfg.norm_ind:
        for i in range(len(spk_ids)):
            sel = spk == i
            cond[sel] = (cond[sel] - min_cond[i]) / (max_cond[i] - min_cond[i])
    else:
        cond = (cond - min_cond) / (max_cond - min_cond)

    np.save(names["data"], data)
    np.save(names["cond"], cond)
    np.save(names["spk"], spk)
    np.save(names["audio_id"], audio_id)

    if cfg.look_ahead:
        cond = _look_ahead(cond, names["cond"])

    return Corpus(data=data, cond=cond, spk=spk, audio_id=audio_id,
                  min_cond=min_cond, max_cond=max_cond, spk_ids=spk_ids)


def utterance_slices(corpus: Corpus, cond_len: int, max_utts: int = 4,
                     max_frames: int = 125):
    """Fixed-length (audio, cond, spk) triples for objective copy-synthesis
    scoring (eval/metrics.py): the first `max_utts` distinct utterances,
    located as contiguous within-lane runs of `audio_id`, all truncated to
    the shortest selected run (capped at `max_frames` conditioner frames)
    so they batch into ONE generation call.

    Returns (audio (k, F*cond_len) float, cond (k, F, D), spk (k,) int32)
    or None when no run of >= 2 frames exists. The audio is the natural
    waveform aligned to the exact conditioner frames the generator will
    consume — the tightest possible copy-synthesis ground truth.
    """
    runs = []
    seen = set()
    n_lanes, lane_frames = corpus.audio_id.shape
    for b in range(n_lanes):
        ids = corpus.audio_id[b]
        start = 0
        for f in range(1, lane_frames + 1):
            if f < lane_frames and ids[f] == ids[start]:
                continue
            uid = int(ids[start])
            if uid not in seen and f - start >= 2:
                seen.add(uid)
                runs.append((b, start, f))
            start = f
            if len(runs) >= max_utts:
                break
        if len(runs) >= max_utts:
            break
    if not runs:
        return None
    n_frames = min(min(f1 - f0 for _, f0, f1 in runs), max_frames)
    audio = np.stack([
        corpus.data[b, f0 * cond_len:(f0 + n_frames) * cond_len]
        for b, f0, _ in runs]).astype(np.float32)
    cond = np.stack([corpus.cond[b, f0:f0 + n_frames]
                     for b, f0, _ in runs]).astype(np.float32)
    spk = np.asarray([int(corpus.spk[b, f0]) for b, f0, _ in runs],
                     np.int32)
    return audio, cond, spk


def _look_ahead(cond: np.ndarray, cond_cache_path: str) -> np.ndarray:
    """Materialize look-ahead conditioners: cond ‖ cond shifted left one
    frame (the last frame duplicates) — ref dataset.py:213-221."""
    ahead_path = cond_cache_path.replace(".npy", "_ahead.npy")
    # trust the cache only if it is newer than the base cond cache — a
    # rebuilt corpus (deleted/changed inputs) must not silently pair fresh
    # conditioners with a stale look-ahead materialization
    if os.path.isfile(ahead_path) and (
            not os.path.isfile(cond_cache_path)
            or os.path.getmtime(ahead_path)
            >= os.path.getmtime(cond_cache_path)):
        return np.load(ahead_path)
    delayed = np.copy(cond)
    delayed[:, :-1, :] = delayed[:, 1:, :]
    out = np.concatenate([cond, delayed], axis=2)
    np.save(ahead_path, out)
    return out


def load_corpus(cfg: CorpusConfig, partition: str) -> Corpus:
    """Load a previously built partition from the npy cache
    (ref dataset.py:208-236)."""
    names = _names(cfg, partition)
    data = np.load(names["data"])
    cond = np.load(names["cond"])
    spk = np.load(names["spk"])
    audio_id = (np.load(names["audio_id"])
                if os.path.isfile(names["audio_id"]) else
                np.zeros_like(spk))
    mm = np.load(names["min_max"])
    spk_ids = np.load(names["spk_id"])
    if cfg.look_ahead:
        cond = _look_ahead(cond, names["cond"])
    return Corpus(data=data, cond=cond, spk=spk, audio_id=audio_id,
                  min_cond=mm[0], max_cond=mm[1], spk_ids=spk_ids)


def normalize_cond(cond: np.ndarray, min_cond: np.ndarray,
                   max_cond: np.ndarray, speaker: Optional[int] = None,
                   norm_ind: bool = False) -> np.ndarray:
    """Normalize conditioners with saved training min/max — the generation
    path's normalization (ref generate.py:180-190)."""
    if norm_ind:
        assert speaker is not None
        return (cond - min_cond[speaker]) / (max_cond[speaker] - min_cond[speaker])
    return (cond - min_cond) / (max_cond - min_cond)
