"""The port's data slice against the JAX package's, on the CPU: WAV I/O,
interpolation, the float64 quantizer, the native data library, log-mel
features and objective metrics, the synthetic corpora, the corpus build and
its npy cache, and the TBPTT chunk loader.

Everything here is host-side numpy in both packages, so every comparison is
bit for bit (assert_array_equal), with one exception stated at its test.
"""

import dataclasses
import filecmp
import os
import struct

import numpy as np
import pytest
import torch

from msnv_tpu.data import corpus as jcorpus
from msnv_tpu.data import loader as jloader
from msnv_tpu.data import native as jnative
from msnv_tpu.data import synthetic as jsynthetic
from msnv_tpu.data import wavio as jwavio
from msnv_tpu.data.mel import log_mel_spectrogram as j_log_mel
from msnv_tpu.eval.metrics import evaluate_pair as j_evaluate_pair
from msnv_tpu.ops.interpolate import interpolation as j_interpolation
from msnv_tpu.ops.quantize import uquantize_np as j_uquantize_np
from msnv_tpu_torch.data import corpus as tcorpus
from msnv_tpu_torch.data import loader as tloader
from msnv_tpu_torch.data import native as tnative
from msnv_tpu_torch.data import synthetic as tsynthetic
from msnv_tpu_torch.data import wavio as twavio
from msnv_tpu_torch.data.mel import log_mel_spectrogram as t_log_mel
from msnv_tpu_torch.eval.metrics import evaluate_pair as t_evaluate_pair
from msnv_tpu_torch.ops.interpolate import interpolation as t_interpolation
from msnv_tpu_torch.ops.quantize import uquantize as t_uquantize
from msnv_tpu_torch.ops.quantize import uquantize_np as t_uquantize_np

CORPUS_FIELDS = ("data", "cond", "spk", "audio_id", "min_cond", "max_cond",
                 "spk_ids")


# --------------------------------------------------------------------------
# WAV I/O
# --------------------------------------------------------------------------

def _pcm24_file(path, levels, channels=1):
    payload = b"".join(int(v & 0xFFFFFF).to_bytes(3, "little")
                       for v in levels)
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(payload), b"WAVE"))
        f.write(struct.pack("<4sI", b"fmt ", 16))
        f.write(struct.pack("<HHIIHH", 1, channels, 16000,
                            16000 * 3 * channels, 3 * channels, 24))
        f.write(struct.pack("<4sI", b"data", len(payload)))
        f.write(payload)


def _raw_wav(path, payload, fmt, channels, bits):
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(payload), b"WAVE"))
        f.write(struct.pack("<4sI", b"fmt ", 16))
        f.write(struct.pack("<HHIIHH", fmt, channels, 16000,
                            16000 * bits // 8 * channels,
                            bits // 8 * channels, bits))
        f.write(struct.pack("<4sI", b"data", len(payload)))
        f.write(payload)


@pytest.mark.parametrize("kind", ["pcm16", "float32", "pcm24", "pcm32",
                                  "stereo_pcm16", "stereo_pcm24"])
def test_read_wav_equals_jax(kind, tmp_path):
    """Each format reads to the same float32 samples and rate as the JAX
    package's read_wav (PCM24 and float WAVs included)."""
    rng = np.random.RandomState(0)
    p = str(tmp_path / "x.wav")
    x = (rng.rand(2401).astype(np.float32) * 1.8 - 0.9)
    if kind in ("pcm16", "float32"):
        jwavio.write_wav(p, x, 16000, dtype=kind)
    elif kind == "pcm24":
        _pcm24_file(p, (rng.rand(801) * 2 ** 24 - 2 ** 23).astype(np.int64))
    elif kind == "stereo_pcm24":
        _pcm24_file(p, (rng.rand(800) * 2 ** 24 - 2 ** 23).astype(np.int64),
                    channels=2)
    elif kind == "pcm32":
        _raw_wav(p, (rng.rand(500) * 2 ** 32 - 2 ** 31).astype("<i4")
                 .tobytes(), 1, 1, 32)
    else:
        _raw_wav(p, (rng.rand(600) * 2 ** 16 - 2 ** 15).astype("<i2")
                 .tobytes(), 1, 2, 16)
    got, sr = twavio.read_wav(p)
    want, sr_j = jwavio.read_wav(p)
    assert sr == sr_j == 16000 and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["pcm16", "float32"])
def test_write_wav_bytes_equal_jax(dtype, tmp_path):
    x = np.sin(np.arange(1000) / 7.0).astype(np.float32) * 0.7
    twavio.write_wav(str(tmp_path / "t.wav"), x, 22050, dtype=dtype)
    jwavio.write_wav(str(tmp_path / "j.wav"), x, 22050, dtype=dtype)
    assert filecmp.cmp(tmp_path / "t.wav", tmp_path / "j.wav", shallow=False)
    with pytest.raises(ValueError):
        twavio.write_wav(str(tmp_path / "bad.wav"), x, 16000, dtype="pcm8")


def test_read_wav_rejects_non_wave(tmp_path):
    p = tmp_path / "n.wav"
    p.write_bytes(b"RIFX" + b"\0" * 40)
    with pytest.raises(ValueError, match="not a RIFF/WAVE"):
        twavio.read_wav(str(p))


# --------------------------------------------------------------------------
# interpolation, quantizer, native library, mel, metrics
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["lf0", "gv", "all_unvoiced", "all_voiced",
                                  "leading_trailing"])
def test_interpolation_equals_jax(case):
    rng = np.random.RandomState(3)
    if case == "lf0":
        sig, sym = np.where(rng.rand(200) > 0.3, rng.randn(200), -2e10), -1e10
    elif case == "gv":
        sig, sym = np.where(rng.rand(150) > 0.4, 4000 + rng.randn(150),
                            500.0), 1e3
    elif case == "all_unvoiced":
        sig, sym = np.full(30, -2e10), -1e10
    elif case == "all_voiced":
        sig, sym = rng.randn(30), -1e10
    else:
        sig, sym = np.array([-2e10, -2e10, 1.0, 2.0, -2e10, 3.0, -2e10]), -1e10
    got, uv = t_interpolation(sig, sym)
    want, uv_j = j_interpolation(sig, sym)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(uv, uv_j)
    assert uv.dtype == uv_j.dtype


def test_uquantize_np_equals_jax_float64_and_float32():
    rng = np.random.RandomState(4)
    x64 = np.concatenate([rng.rand(20000) * 2 - 1,
                          [-1.0, 0.0, 1.0 - 1e-5, 0.5]])
    for x in (x64, x64.astype(np.float32)):
        got = t_uquantize_np(x, 256)
        np.testing.assert_array_equal(got, j_uquantize_np(x, 256))
        assert got.dtype == np.int32


def test_native_library_builds_into_the_port_build_dir():
    assert tnative.available()
    so = tnative._build()
    assert so.parent == tnative.BUILD_DIR and so.name.startswith(
        "libmsnv_data-")


def test_native_entry_points_equal_jax_and_fallbacks(tmp_path, monkeypatch):
    rng = np.random.RandomState(5)
    w = str(tmp_path / "a.wav")
    jwavio.write_wav(w, (rng.rand(3001) * 1.8 - 0.9).astype(np.float32),
                     16000)
    m = rng.randn(37, 40) * 10
    m[::5, 3] = -1e10
    cc = str(tmp_path / "a.cc")
    np.savetxt(cc, m)
    v = str(tmp_path / "a.lf0")
    np.savetxt(v, rng.randn(29))
    x = ((rng.rand(50000) * 2 - 1) * 0.999).astype(np.float32)
    native = (tnative.read_wav(w), tnative.loadtxt(cc), tnative.loadtxt(v),
              tnative.uquantize(x))
    np.testing.assert_array_equal(native[0][0], jnative.read_wav(w)[0])
    np.testing.assert_array_equal(native[1], jnative.loadtxt(cc))
    np.testing.assert_array_equal(native[2], jnative.loadtxt(v))
    np.testing.assert_array_equal(native[3], jnative.uquantize(x))
    # the pure-Python fallbacks give the same values
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", True)
    assert not tnative.available()
    fallback = (tnative.read_wav(w), tnative.loadtxt(cc), tnative.loadtxt(v),
                tnative.uquantize(x))
    for a, b in zip(native[1:3], fallback[1:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(native[0][0], fallback[0][0])
    assert native[0][1] == fallback[0][1] == 16000
    np.testing.assert_array_equal(native[3], fallback[3])
    np.testing.assert_array_equal(
        fallback[3], t_uquantize(torch.from_numpy(x)).numpy())


def test_log_mel_and_metrics_equal_jax():
    rng = np.random.RandomState(6)
    t = np.arange(8000) / 16000
    ref = 0.5 * np.sin(2 * np.pi * 150 * t) + 0.01 * rng.randn(8000)
    gen = 0.4 * np.sin(2 * np.pi * 160 * t) + 0.02 * rng.randn(8000)
    np.testing.assert_array_equal(t_log_mel(ref, n_mels=20),
                                  j_log_mel(ref, n_mels=20))
    got, want = t_evaluate_pair(ref, gen), j_evaluate_pair(ref, gen)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


# --------------------------------------------------------------------------
# synthetic corpora
# --------------------------------------------------------------------------

def _tree_equal(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if os.path.isdir(pa):
            _tree_equal(pa, pb)
        else:
            assert filecmp.cmp(pa, pb, shallow=False), n


def test_synthetic_corpus_files_equal_jax(tmp_path):
    kw = dict(n_speakers=2, utts_per_speaker=2, frames_per_utt=20,
              cond_len=16, partitions=("train", "validation"),
              interleave=True)
    out_t = tsynthetic.make_synthetic_corpus(str(tmp_path / "t"), **kw)
    out_j = jsynthetic.make_synthetic_corpus(str(tmp_path / "j"), **kw)
    assert out_t[2] == out_j[2]
    _tree_equal(str(tmp_path / "t"), str(tmp_path / "j"))


def test_speechlike_corpus_files_equal_jax(tmp_path):
    kw = dict(n_speakers=2, utts_per_speaker=1, seconds_per_utt=0.3)
    assert (tsynthetic.make_speechlike_corpus(str(tmp_path / "t"), **kw)[1]
            == jsynthetic.make_speechlike_corpus(str(tmp_path / "j"),
                                                 **kw)[1])
    _tree_equal(str(tmp_path / "t"), str(tmp_path / "j"))


# --------------------------------------------------------------------------
# corpus build, cache, loader
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_corpus"))
    jsynthetic.make_synthetic_corpus(
        root, n_speakers=2, utts_per_speaker=3, frames_per_utt=60,
        cond_len=16, partitions=("train", "validation"), interleave=True)
    # single-speaker lists for static_spk
    with open(os.path.join(root, "wav_train.list")) as f:
        names = f.read().split()
    for part in ("train", "validation"):
        with open(os.path.join(root, f"wav_{part}_static.list"), "w") as f:
            f.write("\n".join(n for n in names if n.startswith("71")) + "\n")
    return root


def _ccfgs(root, cache, **kw):
    base = dict(datasets_path=root, wav_path=os.path.join(root, "wav"),
                cond_path=os.path.join(root, "cond"), overlap_len=16,
                seq_len=64, batch_size=2, cond_len=16, cache_dir=cache)
    base.update(kw)
    return tcorpus.CorpusConfig(**base), jcorpus.CorpusConfig(**base)


def _assert_corpus_equal(a, b):
    for f in CORPUS_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


CORPUS_CASES = {
    "norm_ind": dict(norm_ind=True),
    "joint": dict(norm_ind=False),
    "look_ahead": dict(norm_ind=True, look_ahead=True),
    "static_spk": dict(norm_ind=False, static_spk=True),
    "mel": dict(norm_ind=False, cond_source="mel", cond_dim=20),
}


@pytest.mark.parametrize("case", sorted(CORPUS_CASES))
def test_corpus_and_cache_equal_jax(case, corpus_root, tmp_path):
    """Both partitions, the min_max table and every cache file equal the
    JAX package's bit for bit; then each package loads the other's cache."""
    kw = CORPUS_CASES[case]
    t_dir, j_dir = str(tmp_path / "t"), str(tmp_path / "j")
    tcfg, _ = _ccfgs(corpus_root, t_dir, **kw)
    _, jcfg = _ccfgs(corpus_root, j_dir, **kw)
    for part in ("train", "validation"):
        _assert_corpus_equal(tcorpus.build_corpus(tcfg, part),
                             jcorpus.build_corpus(jcfg, part))
    _tree_equal(t_dir, j_dir)
    # each package on the other's cache
    tcfg_j, jcfg_t = (dataclasses.replace(tcfg, cache_dir=j_dir),
                      dataclasses.replace(jcfg, cache_dir=t_dir))
    for part in ("train", "validation"):
        _assert_corpus_equal(tcorpus.load_corpus(tcfg_j, part),
                             jcorpus.load_corpus(jcfg_t, part))
        _assert_corpus_equal(tcorpus.build_corpus(tcfg_j, part),
                             jcorpus.build_corpus(jcfg, part))


def test_corpus_errors_match_jax(corpus_root, tmp_path):
    tcfg, jcfg = _ccfgs(corpus_root, str(tmp_path / "c"), batch_size=64)
    with pytest.raises(ValueError, match="corpus too small") as te:
        tcorpus.build_corpus(tcfg, "train")
    with pytest.raises(ValueError) as je:
        jcorpus.build_corpus(jcfg, "train")
    assert str(te.value) == str(je.value)
    tcfg, _ = _ccfgs(corpus_root, str(tmp_path / "d"))
    with pytest.raises(FileNotFoundError):
        tcorpus.build_corpus(tcfg, "test")


def test_utterance_slices_and_normalize_cond_equal_jax(corpus_root, tmp_path):
    tcfg, jcfg = _ccfgs(corpus_root, str(tmp_path / "u"), norm_ind=True)
    tc, jc = (tcorpus.build_corpus(tcfg, "train"),
              jcorpus.build_corpus(jcfg, "train"))
    for a, b in zip(tcorpus.utterance_slices(tc, 16),
                    jcorpus.utterance_slices(jc, 16)):
        np.testing.assert_array_equal(a, b)
    cond = np.random.RandomState(7).rand(9, 43)
    for kw in (dict(speaker=1, norm_ind=True), dict(norm_ind=False)):
        mm = (tc.min_cond, tc.max_cond) if kw["norm_ind"] else (
            tc.min_cond.min(0), tc.max_cond.max(0))
        np.testing.assert_array_equal(
            tcorpus.normalize_cond(cond, *mm, **kw),
            jcorpus.normalize_cond(cond, *mm, **kw))


@pytest.fixture(scope="module")
def loaders(corpus_root, tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("loader_cache"))
    tcfg, jcfg = _ccfgs(corpus_root, cache, norm_ind=True, look_ahead=True)
    tc = tcorpus.build_corpus(tcfg, "train")
    jc = jcorpus.build_corpus(jcfg, "train")
    return (tloader.ChunkLoader(tc, 64, 16, 16),
            jloader.ChunkLoader(jc, 64, 16, 16))


@pytest.mark.parametrize("start_chunk", [0, 3])
def test_every_chunk_equals_jax(loaders, start_chunk):
    tl, jl = loaders
    assert len(tl) == len(jl) > 4
    chunks = list(zip(tl.epoch(start_chunk), jl.epoch(start_chunk)))
    assert len(chunks) == len(jl) - start_chunk
    for a, b in chunks:
        assert a.index == b.index and a.reset == b.reset == (a.index == 0)
        for f in ("data", "target", "cond", "spk"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def test_device_arrays_equal_jax(loaders):
    tl, jl = loaders
    got = tl.device_arrays("cpu")
    want = jl.device_arrays()
    assert tl.device_bytes() == jl.device_bytes()
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["qdata"].dtype == got["spk"].dtype == torch.int32
    assert got["cond"].dtype == torch.float32
    # over a mesh only this rank's lanes are uploaded: the second of two
    # data shards here (the rank's place is all the shardings read)
    from types import SimpleNamespace
    from msnv_tpu_torch.parallel.mesh import corpus_sharding
    rank = SimpleNamespace(shape={"data": 2, "model": 1}, data_index=1)
    mine = tl.device_arrays("cpu", shardings=corpus_sharding(rank))
    half = got["qdata"].shape[0] // 2
    assert torch.equal(mine["qdata"], got["qdata"][half:])
    assert torch.equal(mine["cond"], got["cond"][half:])
    assert torch.equal(mine["spk"], got["spk"][:, half:])
