"""Generation CLI (`msnv-generate-torch`) — batch offline synthesis (ref
generate.py:87-253), in the port.

Usage:
  python -m msnv_tpu_torch.cli.generate --model results/<tag>/checkpoints/best-ep...-it....npz \
      --cond_path <dir> --cond_list generate_cond.list --spk_list generate_spk.list \
      --out_dir <dir> [--device cuda|cpu] [--engine auto|xla|pallas]

Capability parity with the reference:
- the model architecture is re-hydrated from the experiment tag embedded in
  the checkpoint path (ref generate.py:126-129)
- conditioners are loaded from Ahocoder .cc/.lf0/.gv files, interpolated over
  unvoiced runs, and normalized with the SAVED training min/max
  (ref generate.py:158-190)
- look-ahead doubling is applied inline when the model was trained with it
  (ref generate.py:193-197)
- output WAVs are named <ckpt>_file-<utt>_spk-<id>.wav (ref generate.py:98-112)

Deviation from the reference: all utterances in the list are generated in
ONE batched call (cond padded to the longest utterance, outputs trimmed),
instead of rebuilding the model per file.

The same arguments and output names as the JAX package's msnv-generate,
plus --device (default cuda). --engine auto is the kernel path on a CUDA
device (bf16 weights, the bottom tier's windows in the sample-window kernel)
and the per-sample float32 path on the CPU; "xla" names the per-sample path
and "pallas" the kernel path anywhere (on the CPU the kernel's plain
version). --temperature 0 (greedy) takes the per-sample path.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def load_cond_utterance(cond_path: str, name: str):
    """Load + interpolate one utterance's conditioners (43 dims,
    un-normalized) — ref generate.py:158-171. Track loading is shared with
    the corpus build (data/corpus.load_cond_tracks)."""
    from msnv_tpu_torch.data.corpus import load_cond_tracks

    c, f0, fv, uv = load_cond_tracks(cond_path, name)
    n = min(c.shape[0], f0.shape[0], fv.shape[0])
    return np.concatenate(
        [c[:n], f0[:n], fv[:n], uv[:n].astype(np.float64)], axis=1)


def load_mel_utterance(wav_path: str, name: str, cond_dim: int,
                       cond_len: int):
    """Ahocoder-free copy-synthesis conditioning: derive the log-mel track
    from <name>.wav itself (same front-end the cond_source="mel" corpus
    build uses, so the saved training min/max applies)."""
    from msnv_tpu_torch.data import native
    from msnv_tpu_torch.data.mel import mel_cond_track

    d, _sr = native.read_wav(os.path.join(wav_path, name + ".wav"))
    d = d[: (d.shape[0] // cond_len) * cond_len]
    return mel_cond_track(d, cond_dim, cond_len)


def main(argv=None):
    import torch

    from msnv_tpu_torch.config import parse_tag, tag_from_checkpoint_path
    from msnv_tpu_torch.data.corpus import normalize_cond
    from msnv_tpu_torch.data.wavio import write_wav
    from msnv_tpu_torch.device import resolve_device
    from msnv_tpu_torch.models.generate import generate_fn
    from msnv_tpu_torch.models.samplernn import init_params
    from msnv_tpu_torch.training.checkpoint import load_any

    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True,
                   help="checkpoint: an .npz file, a .dcp or .orbax "
                        "directory")
    p.add_argument("--cond_path", required=True)
    p.add_argument("--cond_list", required=True,
                   help="file listing utterance names")
    p.add_argument("--spk_list", required=True,
                   help="file listing speaker indices, one per utterance")
    p.add_argument("--norm_spk_list", default=None,
                   help="optional file of speaker indices used for the "
                        "per-speaker conditioner normalization table "
                        "(norm_ind models), one per utterance. Voice "
                        "conversion decouples the two lists: normalize "
                        "the SOURCE speaker's features with the source's "
                        "table (content extraction) while --spk_list "
                        "carries the TARGET embedding (identity). "
                        "Default: the --spk_list entry (its argmax for "
                        "mixes) — plain copy-synthesis behavior.")
    p.add_argument("--min_max", default=None,
                   help="saved training min_max npy (defaults to "
                        "npy_datasets/min_max_{ind|joint}.npy next to cwd)")
    p.add_argument("--norm_ind", default=None,
                   help="true/false; defaults to the value in the "
                        "checkpoint's experiment tag")
    p.add_argument("--out_dir", default=None)
    p.add_argument("--seed", type=int, default=77977)
    p.add_argument("--cond_source", default="ahocoder",
                   choices=["ahocoder", "mel"],
                   help="mel: cond_path holds <utt>.wav files and "
                        "conditioners are log-mel tracks computed from "
                        "them (models trained with --cond_source mel)")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "xla", "pallas"],
                   help="auto = the sample-window kernel (bf16) on a CUDA "
                        "device, the per-sample float32 path elsewhere; "
                        "xla = the per-sample path, pallas = the kernel "
                        "path")
    p.add_argument("--temperature", type=float, default=1.0,
                   help="sampling temperature: 1.0 = reference multinomial"
                        " semantics, <1 sharpens (mitigates saturation "
                        "bursts), 0 = greedy argmax (xla engine only)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernel's plain "
                        "version")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    # re-hydrate config from the tag in the checkpoint path
    tag = tag_from_checkpoint_path(args.model)
    cfg = parse_tag(tag)
    m = cfg.model
    print("config from tag:", tag)
    if args.norm_ind is None:
        args.norm_ind = cfg.data.norm_ind
    else:
        args.norm_ind = str(args.norm_ind).lower() in ("1", "true", "t")

    with open(args.cond_list) as f:
        utts = f.read().split()

    def parse_spk(entry):
        # eigen-voice (thesis sec 3.3): "0.5,0.5,0,..." mixes the trained
        # speaker embeddings into a new voice; a bare int is a speaker id
        if "," in entry:
            w = np.asarray([float(x) for x in entry.split(",")], np.float32)
            return w
        return int(entry)

    with open(args.spk_list) as f:
        spks = [parse_spk(s) for s in f.read().split()]
    assert len(utts) == len(spks), "cond/spk list length mismatch"
    norm_spks = None
    if args.norm_spk_list is not None:
        with open(args.norm_spk_list) as f:
            norm_spks = [int(s) for s in f.read().split()]
        assert len(norm_spks) == len(utts), \
            "cond/norm_spk list length mismatch"
    for s_ in spks:
        if isinstance(s_, np.ndarray):
            assert s_.shape[0] == m.spk_dim, (
                f"speaker weight vector needs {m.spk_dim} entries, "
                f"got {s_.shape[0]}")

    mel_sfx = "_mel" if args.cond_source == "mel" else ""
    mm_path = args.min_max or os.path.join(
        "npy_datasets",
        f"min_max_{'ind' if args.norm_ind else 'joint'}{mel_sfx}.npy")
    mm = np.load(mm_path)
    min_cond, max_cond = mm[0], mm[1]

    conds = []
    for i, (name, spk) in enumerate(zip(utts, spks)):
        if args.cond_source == "mel":
            cond = load_mel_utterance(args.cond_path, name, m.cond_dim,
                                      m.cond_len)
        else:
            cond = load_cond_utterance(args.cond_path, name)
        # mixed voices normalize with the dominant speaker's table
        # (per-speaker min/max is only defined for trained speakers);
        # --norm_spk_list overrides (voice conversion: source's table)
        if norm_spks is not None:
            norm_spk = norm_spks[i]
        else:
            norm_spk = (int(np.argmax(spk)) if isinstance(spk, np.ndarray)
                        else spk)
        cond = normalize_cond(cond, min_cond, max_cond,
                              speaker=norm_spk, norm_ind=args.norm_ind)
        if m.look_ahead:
            delayed = np.copy(cond)
            delayed[:-1] = delayed[1:]
            cond = np.concatenate([cond, delayed], axis=1)
        conds.append(cond.astype(np.float32))

    # batch: pad to longest utterance, trim after generation
    lengths = [c.shape[0] for c in conds]
    max_frames = max(lengths)
    batch = np.zeros((len(conds), max_frames, m.effective_cond_dim),
                     np.float32)
    for i, c in enumerate(conds):
        batch[i, :c.shape[0]] = c
        batch[i, c.shape[0]:] = c[-1]  # hold last frame through padding

    # rebuild the model's tree and load the weights onto the device
    state, _ = load_any(
        args.model, {"params": init_params(m, device="meta")}, device=device)
    params = state["params"]

    engine = args.engine
    if engine == "auto":
        engine = "pallas" if device.type == "cuda" else "xla"
    if args.temperature == 0.0 and engine == "pallas":
        print("greedy (temperature 0) runs on the per-sample path")
        engine = "xla"
    if engine == "pallas":
        gen = generate_fn(params, m, compute_dtype=torch.bfloat16,
                          use_kernel=True, temperature=args.temperature)
    else:
        gen = generate_fn(params, m, temperature=args.temperature)
    print(f"generation engine: {engine}")
    if any(isinstance(s_, np.ndarray) for s_ in spks):
        # at least one mixed voice: promote every entry to a weight vector
        # (int ids become one-hots) — generate_fn's float-spk path mixes
        # the speaker embeddings
        rows = [s_ if isinstance(s_, np.ndarray)
                else np.eye(m.spk_dim, dtype=np.float32)[s_]
                for s_ in spks]
        spk_arr = torch.from_numpy(np.stack(rows).astype(np.float32))
    else:
        spk_arr = torch.from_numpy(np.asarray(spks, np.int64))
    audio, _ = gen(torch.from_numpy(batch).to(device), spk_arr.to(device),
                   torch.Generator(device=device).manual_seed(args.seed))
    audio = audio.float().cpu().numpy()

    out_dir = args.out_dir or os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(args.model))), "samples")
    os.makedirs(out_dir, exist_ok=True)
    ckpt_name = os.path.basename(os.path.normpath(args.model))
    for ext in (".npz", ".dcp", ".orbax"):
        ckpt_name = ckpt_name.removesuffix(ext)
    for i, (name, spk) in enumerate(zip(utts, spks)):
        wav = audio[i, : lengths[i] * m.lookback]
        label = ("mix" + "-".join(f"{w:g}" for w in spk)
                 if isinstance(spk, np.ndarray) else str(spk))
        out = os.path.join(out_dir,
                           f"{ckpt_name}_file-{name}_spk-{label}.wav")
        write_wav(out, wav, 16000)
        print("wrote", out, f"({wav.shape[0] / 16000.0:.2f}s)")


if __name__ == "__main__":
    main()
