"""Serving artifacts: generation and streaming programs saved with
torch.export.

Port of the JAX package's export.py. An artifact holds, for a set of
(lanes, frames) generation buckets and (lanes, frames_per_push) stream
buckets, the programs that generate them, traced once at build time
(`msnv-export-torch`) and run without the model-building Python: a server
(`msnv-serve-torch --artifact`) loads them and serves matching requests.

What each bucket holds: two `torch.export` programs from
models/generate.program_fns, `init(params, spk) -> (spk_vec, buf, hs)` and
a push of a fixed number of frames `push(params, spk_vec, buf, hs, cond,
draws) -> (buf, hs, audio, samples)`. A generation bucket's push covers a
group of its frames (`frames_per_push`, a divisor of its frames) and
`GenerationArtifact.call` loops over the groups: one program that unrolls
a whole bucket would grow with its length (1,600 frames at 8 s, each of
hundreds of operations).

- The params are an argument of every program, not constants in it, so one
  artifact serves any weights of the same shapes. A program casts them to
  its compute dtype, and on a CUDA device packs the sample-window weights
  (`msnv_torch::pack_window_weights`), on every call.
- A generator cannot cross torch.export: the programs take their randomness
  as a tensor (window seeds for the kernel engine, Gumbel noise for the
  per-sample engine, nothing when greedy), which the loader draws from the
  caller's generator with the live path's calls in its order
  (`draw_tensor`). So an artifact's samples equal the live path's for the
  same seed, and its streaming carry is the live one, (spk_vec, buf, hs,
  generator): a push of either may continue the other's carry.
- The engines keep the JAX names: "pallas" is the sample-window kernel
  (`msnv_torch::sample_window`, which plans on its real inputs at run time),
  "xla" the per-sample path. `platforms` is the device type the programs
  were traced for; they run there only.

File layout (one file):

    MAGIC 'MSNVEXT1' | u32 manifest_len | manifest JSON (UTF-8)
    | concatenated blobs, each one torch.export.save

The JAX package's artifacts (MAGIC 'MSNVEXP1') hold StableHLO, which this
package cannot run: `load_artifact` refuses them, as the JAX loader refuses
these.
"""

from __future__ import annotations

import dataclasses
import io
import json
import struct
from typing import Optional, Sequence

import torch

# registers the msnv_torch operators that the programs call
import msnv_tpu_torch.kernels.sample_window  # noqa: F401
from msnv_tpu_torch.config import ExperimentConfig, ModelConfig, make_tag
from msnv_tpu_torch.models.generate import draw_tensor, program_fns

MAGIC = b"MSNVEXT1"
JAX_MAGIC = b"MSNVEXP1"
# the most frames a generation bucket's push covers
MAX_FRAME_GROUP = 4



def frame_group(n_frames: int) -> int:
    """The frames of a generation bucket's push: the largest divisor of
    n_frames that is at most MAX_FRAME_GROUP."""
    return max(g for g in range(1, min(MAX_FRAME_GROUP, n_frames) + 1)
               if n_frames % g == 0)


# --------------------------------------------------------------------------
# Export (build side)
# --------------------------------------------------------------------------

class _Program(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _save(fn, args) -> bytes:
    with torch.no_grad():
        exported = torch.export.export(_Program(fn), args, strict=False)
    # torch.export.save would write the example arguments too: the params
    # among them (228 MB at the canonical width, in every program)
    exported.example_inputs = None
    out = io.BytesIO()
    torch.export.save(exported, out)
    return out.getvalue()


def _spk_example(cfg: ModelConfig, lanes: int, spk_mix: bool, device):
    if spk_mix:
        return torch.full((lanes, cfg.spk_dim), 1.0 / cfg.spk_dim,
                          device=device)
    return torch.zeros((lanes,), dtype=torch.int32, device=device)


def export_program(params, cfg: ModelConfig, lanes: int, frames: int,
                   which: str, *, temperature: float = 1.0,
                   use_kernel: bool = False, compute_dtype=None,
                   spk_mix: bool = False) -> bytes:
    """Trace one program at `lanes` lanes -> its blob: `which` "init", or
    "push" of `frames` frames (streaming's frames_per_push, or a
    generation bucket's frame group). The params give the shapes, dtypes
    and device of the programs' arguments."""
    init, push = program_fns(cfg, frames, compute_dtype=compute_dtype,
                             use_kernel=use_kernel, temperature=temperature)
    device = params["mlp"]["embedding"].device
    spk = _spk_example(cfg, lanes, spk_mix, device)
    if which == "init":
        return _save(init, (params, spk))
    with torch.no_grad():
        spk_vec, buf, hs = init(params, spk)
    cond = torch.zeros((lanes, frames, cfg.effective_cond_dim),
                       device=device)
    draws = draw_tensor(torch.Generator(device=device).manual_seed(0), cfg,
                        frames, lanes, use_kernel, temperature)
    return _save(push, (params, spk_vec, buf, hs, cond, draws))


def save_artifact(path: str, cfg, buckets, *, temperature: float = 1.0,
                  use_kernel: bool = False, compute_dtype=None,
                  spk_mix: bool = False,
                  platforms: Optional[Sequence[str]] = None,
                  params=None, stream_buckets=None,
                  extra_meta: Optional[dict] = None) -> dict:
    """Export every (lanes, n_frames) in `buckets` and every (lanes,
    frames_per_push) in `stream_buckets`, and write one artifact.

    Returns the manifest. `params` must be given (their shapes, dtypes and
    device define the programs' arguments; the programs are traced for
    their device type, which `platforms`, if given, must name). cfg may be
    a ModelConfig or a full ExperimentConfig.
    """
    if params is None:
        raise ValueError("save_artifact needs params (their shapes are "
                         "part of the programs' arguments)")
    model_cfg = cfg.model if hasattr(cfg, "model") else cfg
    tag = make_tag(cfg) if isinstance(cfg, ExperimentConfig) else None
    device_type = params["mlp"]["embedding"].device.type
    if platforms and list(platforms) != [device_type]:
        raise ValueError(
            f"programs are traced for the device their params are on "
            f"({device_type!r}), not for {list(platforms)}: load the params "
            f"on that device instead")
    opts = {"temperature": temperature, "use_kernel": use_kernel,
            "compute_dtype": compute_dtype, "spk_mix": spk_mix}

    blobs, offset = [], 0
    # (which, lanes, frames) -> (offset, size): buckets share a program
    # where it is the same one (every init at as many lanes; a generation
    # bucket's push and a stream bucket of as many lanes and frames)
    placed = {}

    def place(which, lanes, frames):
        nonlocal offset
        key = (which, int(lanes), int(frames) if which == "push" else 0)
        if key not in placed:
            blob = export_program(params, model_cfg, lanes, frames, which,
                                  **opts)
            placed[key] = (offset, len(blob))
            blobs.append(blob)
            offset += len(blob)
        return placed[key]

    def put(entry, lanes, frames):
        for which in ("init", "push"):
            entry[f"{which}_offset"], entry[f"{which}_size"] = place(
                which, lanes, frames)
        return entry

    entries = [put({"lanes": int(lanes), "frames": int(n_frames),
                    "frames_per_push": frame_group(int(n_frames))},
                   lanes, frame_group(int(n_frames)))
               for lanes, n_frames in buckets]
    stream_entries = [put({"lanes": int(lanes), "frames_per_push": int(k)},
                          lanes, k)
                      for lanes, k in (stream_buckets or [])]

    manifest = {
        "tag": tag,
        "model": dataclasses.asdict(model_cfg),
        "temperature": float(temperature),
        "engine": "pallas" if use_kernel else "xla",
        # "bfloat16", as the JAX package names its dtype
        "compute_dtype": (str(compute_dtype).removeprefix("torch.")
                          if compute_dtype is not None else None),
        "spk_mix": bool(spk_mix),
        "platforms": [device_type],
        "torch_version": torch.__version__,
        "samples_per_frame": model_cfg.lookback,
        "buckets": entries,
        "streams": stream_entries,
    }
    if extra_meta:
        manifest.update(extra_meta)
    mbytes = json.dumps(manifest).encode("utf-8")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(mbytes)))
        f.write(mbytes)
        for blob in blobs:
            f.write(blob)
    return manifest


# --------------------------------------------------------------------------
# Load (deploy side)
# --------------------------------------------------------------------------

def _model_config(d: dict) -> ModelConfig:
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in d.items()})


class GenerationArtifact:
    """Loaded artifact: bucketed generation and streaming programs.

    call(params, cond, spk, generator) picks the exact (lanes, frames)
    bucket; callers pad to a bucket shape themselves (serving already
    buckets by power-of-two lanes and frame_bucket multiples).
    """

    def __init__(self, manifest: dict, programs: dict, streams=None):
        self.manifest = manifest
        self._programs = programs   # (lanes, frames) -> (init, push, group)
        self._streams = streams or {}  # (lanes, K) -> (init, push)
        self._cfg = _model_config(manifest["model"])
        self._use_kernel = manifest["engine"] == "pallas"
        self._temperature = float(manifest["temperature"])

    @property
    def buckets(self):
        return sorted(self._programs)

    @property
    def stream_buckets(self):
        return sorted(self._streams)

    def has_bucket(self, lanes: int, n_frames: int) -> bool:
        return (int(lanes), int(n_frames)) in self._programs

    def has_stream(self, lanes: int, frames_per_push: int) -> bool:
        return (int(lanes), int(frames_per_push)) in self._streams

    def _spk(self, spk, device):
        spk = torch.as_tensor(spk, device=device)
        return spk.float() if spk.is_floating_point() else spk.int()

    def _draws(self, generator, frames, lanes):
        return draw_tensor(generator, self._cfg, frames, lanes,
                           self._use_kernel, self._temperature)

    @torch.no_grad()
    def call(self, params, cond, spk, generator=None):
        """-> (float32 audio (lanes, frames * lookback), int32 samples),
        generate_fn's for the same generator (default: seeded with 0 on
        the params' device)."""
        lanes, n_frames = int(cond.shape[0]), int(cond.shape[1])
        entry = self._programs.get((lanes, n_frames))
        if entry is None:
            raise KeyError(
                f"no bucket for (lanes={lanes}, frames={n_frames}); "
                f"artifact has {self.buckets}")
        init, push, group = entry
        device = params["mlp"]["embedding"].device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        spk_vec, buf, hs = init(params, self._spk(spk, device))
        audio, samples = [], []
        for start in range(0, n_frames, group):
            buf, hs, a, s = push(params, spk_vec, buf, hs,
                                 cond[:, start:start + group],
                                 self._draws(generator, group, lanes))
            audio.append(a)
            samples.append(s)
        return torch.cat(audio, dim=1), torch.cat(samples, dim=1)

    def streaming(self, frames_per_push: int, lanes: int = 1):
        """(init_state, push) over the exported streaming programs,
        signature-compatible with models/generate.streaming_fn but for the
        params, which come first:

          init_state(params, spk, generator=None) -> carry
          push(params, carry, cond) -> (carry, audio, samples)

        The carry is streaming_fn's (spk_vec, buf, hs, generator)."""
        progs = self._streams.get((int(lanes), int(frames_per_push)))
        if progs is None:
            raise KeyError(
                f"no stream bucket (lanes={lanes}, "
                f"frames_per_push={frames_per_push}); artifact has "
                f"{self.stream_buckets}")
        init, push_prog = progs
        k = int(frames_per_push)

        @torch.no_grad()
        def init_state(params, spk, generator=None):
            device = params["mlp"]["embedding"].device
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            return (*init(params, self._spk(spk, device)), generator)

        @torch.no_grad()
        def push(params, carry, cond):
            spk_vec, buf, hs, generator = carry
            frames = cond[:, None] if k == 1 else cond
            buf, hs, audio, samples = push_prog(
                params, spk_vec, buf, hs, frames,
                self._draws(generator, k, frames.shape[0]))
            return (spk_vec, buf, hs, generator), audio, samples

        return init_state, push


def load_artifact(path: str) -> GenerationArtifact:
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic == JAX_MAGIC:
            raise ValueError(
                f"{path}: a JAX package artifact: it holds StableHLO, which "
                f"this package cannot run (export one with "
                f"msnv-export-torch)")
        if magic != MAGIC:
            raise ValueError(f"{path}: not an msnv export artifact "
                             f"(magic {magic!r})")
        (mlen,) = struct.unpack("<I", f.read(4))
        manifest = json.loads(f.read(mlen).decode("utf-8"))
        body = f.read()

    loaded = {}     # a program that several buckets share is loaded once

    def program(offset, size):
        if offset not in loaded:
            loaded[offset] = torch.export.load(
                io.BytesIO(body[offset:offset + size])).module()
        return loaded[offset]

    def pair(ent):
        return (program(ent["init_offset"], ent["init_size"]),
                program(ent["push_offset"], ent["push_size"]))

    programs = {(e["lanes"], e["frames"]): (*pair(e), e["frames_per_push"])
                for e in manifest["buckets"]}
    streams = {(e["lanes"], e["frames_per_push"]): pair(e)
               for e in manifest.get("streams", [])}
    return GenerationArtifact(manifest, programs, streams)
