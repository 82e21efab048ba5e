"""The port's serving artifacts (msnv_tpu_torch/export.py, the
msnv-export-torch CLI) on the CPU, against the port's live generation and
the JAX package's artifacts.

Every case of tests/test_export.py, for both engines: an artifact's
generation and its streaming pushes (a K-frame push then a 1-frame tail on
one carry) equal the live path's exactly for the same seed; the params are
call-time; unknown buckets and bad magic raise; the speaker-mix ABI; the
CLI. Besides: at temperature 0 a port artifact's samples equal a JAX
artifact's from the same weights (exact, as the greedy generation tests
hold them), each package's loader refuses the other's file, and the
sample-window operator the programs call equals its wrapper.
"""

import io
import json
import os
import struct

import jax
import numpy as np
import pytest
import torch

from msnv_tpu import export as jexport
from msnv_tpu.config import ExperimentConfig as JaxExperimentConfig
from msnv_tpu.config import ModelConfig
from msnv_tpu.config import make_tag as jax_make_tag
from msnv_tpu.training.checkpoint import save_checkpoint as jax_save
from msnv_tpu_torch import export as texport
from msnv_tpu_torch.config import ExperimentConfig, make_tag
from msnv_tpu_torch.kernels import sample_window as sw
from msnv_tpu_torch.models import generate as tgen
from msnv_tpu_torch.models.samplernn import init_params
from torch_parity import both_params, torch_cfg

ENGINES = {"xla": False, "pallas": True}
# 4 samples a frame: a traced push grows with the samples it makes, and
# the per-sample path's by some 50 operations a sample
MODEL = ModelConfig(frame_sizes=(2, 2), n_rnn=1, dim=16, cond_dim=5,
                    spk_dim=3)
JAX_EXP = JaxExperimentConfig(exp="export", model=MODEL)


@pytest.fixture(scope="module")
def tiny():
    jparams, tparams = both_params(MODEL)
    return ExperimentConfig(exp="export", model=torch_cfg(MODEL)), tparams, \
        jparams


def _inputs(m, lanes, frames, seed=3):
    rng = np.random.RandomState(seed)
    cond = torch.from_numpy(
        rng.rand(lanes, frames, m.effective_cond_dim).astype(np.float32))
    spk = torch.from_numpy(rng.randint(0, m.spk_dim, (lanes,))
                           .astype(np.int32))
    return cond, spk


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _equal(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_artifact_matches_live_generation(tiny, tmp_path, engine):
    exp, params, _ = tiny
    m = exp.model
    path = str(tmp_path / "tiny.msnvt")
    manifest = texport.save_artifact(path, exp, [(2, 3), (1, 2)],
                                     params=params,
                                     use_kernel=ENGINES[engine])
    assert manifest["tag"] == make_tag(exp)
    assert manifest["engine"] == engine
    assert manifest["platforms"] == ["cpu"]
    assert [(e["lanes"], e["frames"], e["frames_per_push"])
            for e in manifest["buckets"]] == [(2, 3, 3), (1, 2, 2)]

    art = texport.load_artifact(path)
    assert art.buckets == [(1, 2), (2, 3)]
    live = tgen.generate_fn(params, m, use_kernel=ENGINES[engine])
    for lanes, frames in art.buckets:
        cond, spk = _inputs(m, lanes, frames)
        audio_a, seq_a = art.call(params, cond, spk, _gen(11))
        audio_l, seq_l = live(cond, spk, _gen(11))
        _equal(seq_a, seq_l)
        _equal(audio_a, audio_l)


def test_generation_loops_over_frame_groups(tiny, tmp_path):
    """A bucket longer than a frame group runs its push once per group,
    and equals the live path over the whole bucket."""
    exp, params, _ = tiny
    m = exp.model
    path = str(tmp_path / "g.msnvt")
    manifest = texport.save_artifact(path, m, [(1, 8)], params=params,
                                     use_kernel=True)
    assert manifest["tag"] is None
    assert manifest["buckets"][0]["frames_per_push"] == 4
    art = texport.load_artifact(path)
    cond, spk = _inputs(m, 1, 8)
    _, seq_a = art.call(params, cond, spk, _gen(2))
    _, seq_l = tgen.generate_fn(params, m, use_kernel=True)(cond, spk,
                                                          _gen(2))
    _equal(seq_a, seq_l)
    assert [texport.frame_group(n) for n in (1, 2, 3, 5, 6, 16)] == \
        [1, 2, 3, 1, 3, 4]


def test_artifact_params_are_call_time(tiny, tmp_path):
    """Same artifact, different weights -> different (correct) output."""
    exp, params, _ = tiny
    m = exp.model
    path = str(tmp_path / "p.msnvt")
    texport.save_artifact(path, exp, [(1, 2)], params=params,
                          use_kernel=True)
    art = texport.load_artifact(path)
    params2 = init_params(m, _gen(9), device="cpu")
    cond, spk = _inputs(m, 1, 2)
    _, seq1 = art.call(params, cond, spk, _gen(5))
    _, seq2 = art.call(params2, cond, spk, _gen(5))
    _, seq2_live = tgen.generate_fn(params2, m, use_kernel=True)(cond, spk,
                                                                _gen(5))
    _equal(seq2, seq2_live)
    assert not torch.equal(seq1, seq2)


def test_artifact_holds_no_weights(tiny, tmp_path):
    """The programs take the params as arguments: no weight is a constant
    or a buffer of a program, nor saved as an example argument."""
    exp, params, _ = tiny
    path = str(tmp_path / "w.msnvt")
    manifest = texport.save_artifact(path, exp, [(1, 1)], params=params,
                                     use_kernel=True)
    with open(path, "rb") as f:
        body = f.read()
    start = len(texport.MAGIC) + 4 + struct.unpack(
        "<I", body[len(texport.MAGIC):len(texport.MAGIC) + 4])[0]
    for which in ("init", "push"):
        ent = manifest["buckets"][0]
        offset = start + ent[f"{which}_offset"]
        program = torch.export.load(
            io.BytesIO(body[offset:offset + ent[f"{which}_size"]]))
        assert program.example_inputs is None
        assert not program.state_dict and not program.constants


def test_artifact_rejects_unknown_bucket_and_bad_magic(tiny, tmp_path):
    exp, params, _ = tiny
    path = str(tmp_path / "b.msnvt")
    texport.save_artifact(path, exp, [(1, 2)], params=params)
    art = texport.load_artifact(path)
    cond, spk = _inputs(exp.model, 2, 2)
    with pytest.raises(KeyError, match="no bucket"):
        art.call(params, cond, spk, _gen(0))

    bad = str(tmp_path / "bad.msnvt")
    with open(bad, "wb") as f:
        f.write(b"NOTMAGIC" + struct.pack("<I", 2) + b"{}")
    with pytest.raises(ValueError, match="not an msnv export artifact"):
        texport.load_artifact(bad)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_spk_mix_artifact(tiny, tmp_path, engine):
    """Eigen-voice ABI: float embedding weights instead of ids."""
    exp, params, _ = tiny
    m = exp.model
    path = str(tmp_path / "mix.msnvt")
    texport.save_artifact(path, exp, [(1, 2)], params=params, spk_mix=True,
                          use_kernel=ENGINES[engine])
    art = texport.load_artifact(path)
    assert art.manifest["spk_mix"] is True
    cond, _ = _inputs(m, 1, 2)
    mix = torch.ones((1, m.spk_dim)) / m.spk_dim
    audio_a, seq_a = art.call(params, cond, mix, _gen(2))
    audio_l, seq_l = tgen.generate_fn(params, m, use_kernel=ENGINES[engine])(
        cond, mix, _gen(2))
    _equal(seq_a, seq_l)
    _equal(audio_a, audio_l)


@pytest.fixture()
def tiny_checkpoint(tiny, tmp_path):
    """A checkpoint written by the JAX trainer, laid out the reference way:
    results/<tag>/checkpoints/<ckpt> (ref generate.py:126-129)."""
    exp, _, jparams = tiny
    ckpt_dir = tmp_path / "results" / make_tag(exp) / "checkpoints"
    ckpt_dir.mkdir(parents=True)
    path = str(ckpt_dir / "best-ep1-it1.npz")
    jax_save(path, {"params": jparams})
    return path


def test_export_cli(tiny, tiny_checkpoint, tmp_path, capsys):
    """msnv-export-torch end to end from a JAX-trainer checkpoint."""
    from msnv_tpu_torch.cli.export import main as export_main
    exp, params, _ = tiny
    m = exp.model
    out = str(tmp_path / "cli.msnvt")
    # default --frame_bucket 16 rounds frames up to serving's padding
    # geometry; --frame_bucket 1 keeps the exact count
    export_main(["--model", tiny_checkpoint, "--out", out + ".b16",
                 "--lanes", "1", "--frames", "2", "--engine", "pallas",
                 "--device", "cpu"])
    assert texport.load_artifact(out + ".b16").buckets == [(1, 16)]
    export_main(["--model", tiny_checkpoint, "--out", out, "--lanes", "1,2",
                 "--frames", "2", "--frame_bucket", "1", "--engine",
                 "pallas", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["bytes"] == os.path.getsize(out)
    assert printed["engine"] == "pallas" and printed["platforms"] == ["cpu"]
    art = texport.load_artifact(out)
    assert art.buckets == [(1, 2), (2, 2)]
    with open(out, "rb") as f:
        assert f.read(len(texport.MAGIC)) == texport.MAGIC
    cond, spk = _inputs(m, 2, 2)
    audio, seq = art.call(params, cond, spk, _gen(1))
    assert audio.shape == (2, 2 * m.lookback)
    assert torch.isfinite(audio).all()
    _equal(seq, tgen.generate_fn(params, m, use_kernel=True)(cond, spk,
                                                           _gen(1))[1])


def test_export_cli_warns_and_checks_its_flags(tiny_checkpoint, tmp_path,
                                               capsys, monkeypatch):
    from msnv_tpu_torch.cli.export import main as export_main
    base = ["--model", tiny_checkpoint, "--out", str(tmp_path / "w.msnvt"),
            "--frames", "1", "--frame_bucket", "1"]
    export_main(base + ["--lanes", "3", "--engine", "pallas", "--device",
                        "cpu"])
    assert "lanes=3 is not a power of two" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        export_main(base + ["--device", "cpu", "--platforms", "cuda"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_main(base)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_stream_artifact_matches_live(tiny, tmp_path, engine):
    """The exported streaming programs reproduce the live streaming_fn
    sample-exactly, including a K-push followed by 1-frame pushes on the
    same carry (the serving trailing-frames path), and the carry crosses
    between the artifact and the live path."""
    exp, params, _ = tiny
    m = exp.model
    use_kernel = ENGINES[engine]
    path = str(tmp_path / "s.msnvt")
    manifest = texport.save_artifact(path, exp, [], params=params,
                                     stream_buckets=[(1, 1), (1, 2)],
                                     use_kernel=use_kernel)
    assert [(e["lanes"], e["frames_per_push"]) for e in
            manifest["streams"]] == [(1, 1), (1, 2)]
    # both buckets have 1 lane: one init program serves them
    assert len({e["init_offset"] for e in manifest["streams"]}) == 1
    assert len({e["push_offset"] for e in manifest["streams"]}) == 2
    art = texport.load_artifact(path)
    assert art.stream_buckets == [(1, 1), (1, 2)]

    cond = torch.from_numpy(np.random.RandomState(0).rand(
        1, 5, m.effective_cond_dim).astype(np.float32))
    spk = torch.zeros((1,), dtype=torch.int32)

    # live reference: K=2 pushes then a 1-frame tail
    li2, lp2 = tgen.streaming_fn(params, m, frames_per_push=2,
                                 use_kernel=use_kernel)
    _, lp1 = tgen.streaming_fn(params, m, frames_per_push=1,
                               use_kernel=use_kernel)
    carry = li2(1, spk, _gen(4))
    live = []
    for s in range(0, 4, 2):
        carry, _, smp = lp2(carry, cond[:, s:s + 2])
        live.append(smp)
    carry, _, smp = lp1(carry, cond[:, 4])
    live.append(smp)

    ai2, ap2 = art.streaming(2)
    _, ap1 = art.streaming(1)
    carry = ai2(params, spk, _gen(4))
    got = []
    for s in range(0, 4, 2):
        carry, _, smp = ap2(params, carry, cond[:, s:s + 2])
        got.append(smp)
    carry, _, smp = ap1(params, carry, cond[:, 4])
    got.append(smp)
    for a, b in zip(got, live):
        _equal(a, b)

    # an artifact carry continued by a live push, and the other way round
    carry = ai2(params, spk, _gen(4))
    carry, _, a = ap2(params, carry, cond[:, 0:2])
    carry, _, b = lp2(carry, cond[:, 2:4])
    carry, _, c = ap1(params, carry, cond[:, 4])
    _equal(torch.cat([a, b, c], 1), torch.cat(live, 1))

    with pytest.raises(KeyError, match="no stream bucket"):
        art.streaming(7)


def test_export_cli_stream(tiny_checkpoint, tmp_path):
    from msnv_tpu_torch.cli.export import main as export_main
    out = str(tmp_path / "cs.msnvt")
    export_main(["--model", tiny_checkpoint, "--out", out, "--lanes", "1",
                 "--frames", "2", "--frame_bucket", "1", "--stream", "1,2",
                 "--engine", "pallas", "--device", "cpu"])
    art = texport.load_artifact(out)
    assert art.stream_buckets == [(1, 1), (1, 2)]
    assert art.buckets == [(1, 2)]


def test_greedy_artifact_equals_jax_artifact(tiny, tmp_path):
    """From the same weights (crossed under the checkpoint keys), a JAX
    artifact and a port artifact at temperature 0 make the same samples,
    and their manifests agree."""
    exp, tparams, jparams = tiny
    jexp = JAX_EXP
    jpath, tpath = str(tmp_path / "j.msnvx"), str(tmp_path / "t.msnvt")
    kw = {"temperature": 0.0, "stream_buckets": [(1, 1), (1, 2)]}
    jman = jexport.save_artifact(jpath, jexp, [(2, 3), (1, 2)],
                                 params=jparams, **kw)
    tman = texport.save_artifact(tpath, exp, [(2, 3), (1, 2)],
                                 params=tparams, **kw)
    for key in ("tag", "model", "temperature", "spk_mix",
                "samples_per_frame", "engine", "compute_dtype"):
        assert jman[key] == tman[key], key
    assert jman["tag"] == jax_make_tag(jexp)
    assert [(e["lanes"], e["frames"]) for e in jman["buckets"]] == \
        [(e["lanes"], e["frames"]) for e in tman["buckets"]]
    assert [(e["lanes"], e["frames_per_push"]) for e in jman["streams"]] == \
        [(e["lanes"], e["frames_per_push"]) for e in tman["streams"]]

    cond, spk = _inputs(exp.model, 2, 3, seed=6)
    _, seq_j = jexport.load_artifact(jpath).call(
        jparams, jax.numpy.asarray(cond.numpy()),
        jax.numpy.asarray(spk.numpy()), jax.random.PRNGKey(0))
    _, seq_t = texport.load_artifact(tpath).call(tparams, cond, spk)
    np.testing.assert_array_equal(seq_t.numpy(), np.asarray(seq_j))


def test_loaders_refuse_each_others_files(tiny, tmp_path):
    exp, tparams, jparams = tiny
    jpath, tpath = str(tmp_path / "j.msnvx"), str(tmp_path / "t.msnvt")
    jexport.save_artifact(jpath, JAX_EXP, [(1, 1)], params=jparams)
    texport.save_artifact(tpath, exp, [(1, 1)], params=tparams)
    with pytest.raises(ValueError, match="StableHLO"):
        texport.load_artifact(jpath)
    with pytest.raises(ValueError, match="not an msnv export artifact"):
        jexport.load_artifact(tpath)


def test_save_artifact_checks_params_and_platforms(tiny, tmp_path):
    exp, params, _ = tiny
    with pytest.raises(ValueError, match="needs params"):
        texport.save_artifact(str(tmp_path / "x"), exp, [(1, 1)])
    with pytest.raises(ValueError, match="traced for the device"):
        texport.save_artifact(str(tmp_path / "x"), exp, [(1, 1)],
                              params=params, platforms=["cuda"])


def test_draw_tensor_makes_the_live_draws():
    """draw_tensor's rows are the live path's draws in its order, and
    leave the generator where the live path leaves it."""
    m = torch_cfg(MODEL)
    assert tgen.draw_count(m, 3, use_kernel=True) == 3 * m.lookback // 2
    assert tgen.draw_count(m, 3) == 3 * m.lookback
    assert tgen.draw_count(m, 3, temperature=0.0) == 0
    assert tgen.draw_tensor(_gen(0), m, 3, 2, temperature=0.0) is None
    g1, g2 = _gen(7), _gen(7)
    seeds = tgen.draw_tensor(g1, m, 2, 3, use_kernel=True)
    assert seeds.shape == (2 * m.lookback // 2,) and \
        seeds.dtype == torch.int64
    want = [torch.randint(0, 2 ** 62, (1,), generator=g2, dtype=torch.int64)
            for _ in range(seeds.shape[0])]
    _equal(seeds, torch.cat(want))
    noise = tgen.draw_tensor(g1, m, 1, 3)
    assert noise.shape == (m.lookback, 3, m.q_levels)
    want = torch.stack([sw.gumbel_noise((3, m.q_levels), g2)
                        for _ in range(m.lookback)])
    _equal(noise, want)
    _equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))


def test_window_operators_match_the_wrapper_and_trace():
    """`msnv_torch::sample_window` equals `sample_window` in its Philox
    mode; its fake gives the (B, fs0) int32 shape under torch.export; the
    packing operator on the CPU returns W_h and W_o joined."""
    rng = np.random.RandomState(0)
    B, fs0, q, dim = 3, 4, 16, 32

    def f(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.3)

    table, wh, bh, wo, bo = f(fs0 * q, dim), f(dim, dim), f(dim), f(dim, q), \
        f(q)
    slots = f(B, fs0, dim)
    buf = torch.from_numpy(rng.randint(0, q, (B, 2 * fs0)).astype(np.int32))
    seed = torch.tensor([12345], dtype=torch.int64)
    want = sw.sample_window(table, wh, bh, wo, bo, slots, buf[:, -fs0:],
                            seed=seed)
    got = sw.sample_window_op(table, wh, bh, wo, bo, slots, buf[:, -fs0:],
                              seed, None)
    _equal(got, want)
    packed = torch.ops.msnv_torch.pack_window_weights(wh, wo, fs0)
    _equal(packed, torch.cat([wh.reshape(-1), wo.reshape(-1)]))

    class Window(torch.nn.Module):
        def forward(self, table, wh, bh, wo, bo, slots, buf, seed):
            packed = torch.ops.msnv_torch.pack_window_weights(wh, wo, fs0)
            return torch.ops.msnv_torch.sample_window(
                table, wh, bh, wo, bo, slots, buf[:, -fs0:], seed, packed)

    args = (table, wh, bh, wo, bo, slots, buf, seed)
    program = torch.export.export(Window(), args)
    targets = {str(n.target) for n in program.graph.nodes
               if n.op == "call_function"}
    assert {"msnv_torch.sample_window.default",
            "msnv_torch.pack_window_weights.default"} <= targets
    _equal(program.module()(*args), want)
