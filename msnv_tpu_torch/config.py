"""Typed configuration system with experiment-tag round-trip.

The PyTorch port keeps its own copy of the JAX package's config module
(same fields, presets and tag format), so a tag written by either package
rebuilds the same model in the other.

The reference stores its run configuration as a serialized "experiment tag"
that names the results directory (ref train.py:66-107 ``make_tag``) and is
parsed back out of checkpoint paths at generation time (ref generate.py:56-67,
126-129).  We keep that capability — a config can be serialized to a tag
string and re-hydrated from it — on top of typed dataclasses with named
presets for the BASELINE configs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (ref train.py:31-65 default_params)."""

    # Tier frame sizes, lowest tier first; n_frame_samples = cumprod.
    # Canonical run: [20, 4] -> tiers see 20 and 80 samples (ref run_samplernn.sh).
    frame_sizes: Tuple[int, ...] = (20, 4)
    n_rnn: int = 1               # GRU layers per tier (run: 2)
    dim: int = 1024              # hidden width of every GRU / MLP layer
    learn_h0: bool = True        # learned initial hidden state (ref model.py:79-83)
    q_levels: int = 256          # audio quantization levels
    ulaw: bool = True            # mu-law companding (ref utils.py:29-63)
    weight_norm: bool = False    # weight normalization on conv/dense layers
    cond_dim: int = 43           # acoustic conditioner dims per frame (pre look-ahead)
    cond_len: int = 80           # audio samples per conditioner frame (5 ms @ 16 kHz)
    spk_dim: int = 6             # number of speakers == speaker-embedding size
    look_ahead: bool = False     # feed next frame's conditioners too (43 -> 86)
    # recurrent-sweep engine for training/eval tier GRUs (ops/gru.py): "xla"
    # (the name kept for tag/checkpoint compatibility) is a plain
    # layer-by-layer loop of matmuls; "pallas" runs each layer's sweep in
    # the fused GRU-layer CUDA kernels (kernels/gru_layer.py; their plain
    # versions on a CPU tensor); "wavefront" runs all layers in one
    # diagonal sweep. Numerics-equivalent; not part of the experiment tag.
    gru_impl: str = "xla"
    # gradient path for the sample-MLP's embed+conv input stage: "fused"
    # (reassociated custom VJP through the composite table, ops/embed_conv.py
    # — halves the backward FLOPs) or "direct" (plain autodiff baseline).
    # Same forward either way; not part of the experiment tag.
    mlp_grad_impl: str = "fused"
    qrnn: bool = False           # fo-pool QRNN tiers (ops/qrnn.py); the reference flag is dead — both its branches build a GRU (ref model.py:133-153)

    # Variant head on the conditioner stack (ref doc/Barbany_report.pdf sec 3.2):
    #   "identity"   — plain cond_expand (samplernn)
    #   "bottleneck" — narrowing 1x1-conv stack 43->40->30->20->ind_cond_dim
    #   "gan"        — ConditionerCNN + adversarial speaker discriminator
    variant: str = "identity"
    ind_cond_dim: int = 50       # speaker-independent latent dim for variants

    @property
    def ns_frame_samples(self) -> Tuple[int, ...]:
        """Receptive field of each tier in samples (cumprod of frame_sizes)."""
        out, acc = [], 1
        for fs in self.frame_sizes:
            acc *= fs
            out.append(acc)
        return tuple(out)

    @property
    def lookback(self) -> int:
        """Samples of context before the first prediction (top tier's frame).

        ref model.py:60-62.
        """
        return self.ns_frame_samples[-1]

    @property
    def effective_cond_dim(self) -> int:
        """cond_dim after optional look-ahead doubling (ref train.py:213)."""
        return self.cond_dim * (2 if self.look_ahead else 1)

    @property
    def n_tiers(self) -> int:
        return len(self.frame_sizes)


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (ref train.py:31-65, run_samplernn.sh)."""

    seq_len: int = 1040          # samples back-propagated per TBPTT chunk
    batch_size: int = 128        # number of parallel lane-streams
    learning_rate: float = 1e-3  # run scripts use 1e-4
    epoch_limit: int = 1000
    loss_smoothing: float = 0.99  # EMA smoothing of the logged training loss
    seed: int = 77977
    scheduler: bool = False      # MultiStepLR(milestones=[15,35], gamma=0.1)
    scheduler_milestones: Tuple[int, ...] = (15, 35)
    scheduler_gamma: float = 0.1
    grad_clip: float = 1.0       # element-wise grad clip to [-1, 1] (ref optim.py:4-21)
    keep_old_checkpoints: bool = False
    resume: bool = True
    # GAN variant: lambda ramp (start, target, ramp_steps) (ref run_samplegan.sh)
    lambda_weight: Tuple[float, float, float] = (0.0, 0.01, 50000.0)
    # GAN variant, adaptive lambda (round 5; no reference analogue — the
    # thesis uses a fixed ramp). (target_nll, gain, max_mult) or None.
    # The frontier study (docs/VOICE_CONVERSION.md "round 5") measured that
    # a fixed lambda stops winning once the task loss flattens: the in-loop
    # discriminator NLL collapses toward 0, its latent gradient saturates,
    # and conversion decays (0.83/0.93 -> 0.60/0.67 F0/spec->target at
    # 380 epochs). When set, the ramped lambda is scaled each step by
    # exp(gain * (target_nll - L2)) clipped to [1/max_mult, max_mult]:
    # lambda grows while the discriminator beats the target NLL (speaker
    # still recoverable from the latent) and relaxes when the conditioner
    # wins — a stateless proportional controller, so the step signature,
    # checkpoints, and the scan/mesh forms are unchanged. A natural
    # target_nll is ln(spk_dim)/2 (half the chance-level NLL).
    lambda_adaptive: Optional[Tuple[float, float, float]] = None
    # GAN discriminator width; 512 = thesis spec (doc §3.2.2, fig 3.5).
    # Smaller values are for CPU tests/smokes — the 512-channel disc costs
    # ~170 MFLOP per audio sample, minutes per step on a 2-vCPU box.
    disc_channels: int = 512
    # Exposure-bias mitigation (round 5; no reference analogue — the
    # thesis only DESCRIBES the failure mode, the saturation bursts of
    # doc/Barbany_report.pdf §4.3). Training-loop-only changes; eval and
    # generation are untouched.
    #   ss_prob: parallel scheduled sampling — a teacher-forced forward
    #     samples the model's own predictions, and each input position
    #     (past the lookback seed) is replaced by the model's sample with
    #     this probability before the loss forward (two forwards, one
    #     backward; fully batched, no sequential loop).
    #   input_noise_prob/levels: each input sample is jittered by up to
    #     +-levels quantization levels with this probability (targets
    #     stay clean) — denoising-style context robustness.
    ss_prob: float = 0.0
    input_noise_prob: float = 0.0
    input_noise_levels: int = 8

    def __post_init__(self):
        # max_mult < 1 makes the clip's bounds [1/max_mult, max_mult] cross
        # and gain < 0 turns the controller around: both silently invert
        # what lambda_adaptive is for, so they are refused here
        if self.lambda_adaptive is not None:
            _, gain, max_mult = self.lambda_adaptive
            if not max_mult >= 1.0 or not gain >= 0.0:
                raise ValueError(
                    f"lambda_adaptive (target_nll, gain, max_mult) needs "
                    f"gain >= 0 and max_mult >= 1, got "
                    f"{tuple(self.lambda_adaptive)}")


@dataclass(frozen=True)
class DataConfig:
    """Data pipeline parameters (ref dataset.py, train.py)."""

    datasets_path: str = "datasets"
    cond_path: str = "datasets"
    dataset: str = "wav/"
    cond_set: str = "cond/"
    results_path: str = "results"
    sample_rate: int = 16000
    norm_ind: bool = True        # per-speaker (True) vs joint conditioner min/max
    static_spk: bool = False     # single-speaker training lists
    partition_lists: str = ""    # dir holding wav_{train,validation,test}.list


@dataclass(frozen=True)
class ExperimentConfig:
    exp: str = "samplernn"
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)


# --------------------------------------------------------------------------
# Experiment tag round-trip (ref train.py:66-85, generate.py:56-67)
# --------------------------------------------------------------------------

# Fields serialized into the tag, mirroring ref train.py:66-69 tag_params.
_TAG_FIELDS = [
    ("exp", None, None),
    ("frame_sizes", "model", "frame_sizes"),
    ("n_rnn", "model", "n_rnn"),
    ("dim", "model", "dim"),
    ("learn_h0", "model", "learn_h0"),
    ("ulaw", "model", "ulaw"),
    ("q_levels", "model", "q_levels"),
    ("seq_len", "train", "seq_len"),
    ("look_ahead", "model", "look_ahead"),
    ("norm_ind", "data", "norm_ind"),
    ("batch_size", "train", "batch_size"),
    ("dataset", "data", "dataset"),
    ("cond_set", "data", "cond_set"),
    ("static_spk", "data", "static_spk"),
    ("seed", "train", "seed"),
    ("weight_norm", "model", "weight_norm"),
    ("qrnn", "model", "qrnn"),
    ("scheduler", "train", "scheduler"),
    ("learning_rate", "train", "learning_rate"),
    ("variant", "model", "variant"),
    ("ind_cond_dim", "model", "ind_cond_dim"),
    ("ss_prob", "train", "ss_prob"),
    ("input_noise", "train", "input_noise_prob"),
    # Extra architecture-defining fields the reference derives from the
    # dataset at runtime (spk_dim: train.py:201-202) — serialized here so a
    # tag alone fully reconstructs the model.
    ("cond_dim", "model", "cond_dim"),
    ("cond_len", "model", "cond_len"),
    ("spk_dim", "model", "spk_dim"),
]


def _to_string(value) -> str:
    if isinstance(value, bool):
        return "T" if value else "F"
    if isinstance(value, (list, tuple)):
        return ",".join(_to_string(v) for v in value)
    if isinstance(value, str):
        # the tag names a SINGLE directory level: a path separator in a
        # value (e.g. a non-default cond_set "wav/") would silently nest
        # results/<tag-prefix>/<tag-suffix> and break experiment
        # enumeration + tag_from_checkpoint_path (latent in ref
        # train.py:72-85, where default-valued 'cond/' never hit it).
        # Injective escape: '+' is the lead and is itself escaped first,
        # so values containing literal '+' round-trip too (every '+' in
        # an encoded value is followed by 'p' or 's', making decode
        # unambiguous).
        return value.replace("+", "+p").replace("/", "+s")
    return str(value)


def _get(cfg: ExperimentConfig, sub: Optional[str], name: str):
    obj = cfg if sub is None else getattr(cfg, sub)
    return getattr(obj, name)


def make_tag(cfg: ExperimentConfig) -> str:
    """Serialize non-default fields into a `key:value~key:value` tag.

    Matches the semantics of ref train.py:72-85: only values differing from
    the defaults appear (plus `exp`, which has no default-suppression in
    practice since it is always explicitly set).
    """
    defaults = ExperimentConfig(exp=cfg.exp)
    parts = []
    for key, sub, name in _TAG_FIELDS:
        attr = name or key
        value = _get(cfg, sub, attr)
        # exp and frame_sizes are always emitted: in the reference both are
        # required CLI args with no default (ref train.py:343-348), so they
        # always appear in the tag.
        if key in ("exp", "frame_sizes") or value != _get(defaults, sub, attr):
            parts.append(f"{key}:{_to_string(value)}")
    return "~".join(parts)


def _as_type(value: str, like):
    """Parse a tag value string back to the type of `like` (ref generate.py:56-67)."""
    if isinstance(like, bool):
        return value == "T"
    if isinstance(like, int):
        return int(value)
    if isinstance(like, float):
        return float(value)
    if isinstance(like, (list, tuple)):
        elems = value.split(",")
        if len(like):
            return tuple(_as_type(e, like[0]) for e in elems)
        return tuple(int(e) for e in elems)
    # inverse of _to_string's path escape: in encoded values every '+'
    # leads a '+p'/'+s' pair. A '+' followed by anything else can only
    # come from the short-lived earlier scheme that encoded '/' as a bare
    # '+' — decode it as '/' so directories written under that scheme
    # still round-trip (resume finds them instead of silently restarting).
    # Limitation (inherent to the legacy scheme, not the decoder): a
    # legacy-encoded path component that STARTS with 'p' or 's' (e.g.
    # 'a/path' -> 'a+path') is indistinguishable from the new escapes and
    # mis-decodes ('a+ath'); the fallback warns so that's discoverable.
    out, i = [], 0
    legacy = False
    while i < len(value):
        c = value[i]
        if c == "+":
            nxt = value[i + 1] if i + 1 < len(value) else ""
            if nxt == "p":
                out.append("+")
                i += 2
                continue
            if nxt == "s":
                out.append("/")
                i += 2
                continue
            out.append("/")   # legacy bare-'+' escape
            legacy = True
            i += 1
            continue
        out.append(c)
        i += 1
    decoded = "".join(out)
    if legacy:
        import warnings
        warnings.warn(
            f"tag value {value!r} used the legacy bare-'+' path escape; "
            f"decoded as {decoded!r}. If the original path had a '+' "
            f"followed by 'p'/'s' this decode is wrong — re-create the "
            f"experiment directory under the current tag scheme.",
            stacklevel=2)
    return decoded


def tag_from_checkpoint_path(path: str) -> str:
    """Experiment tag from a results/<tag>/checkpoints/<ckpt> path — the
    reference's config store is the directory name (ref generate.py:126-129);
    shared by the generate/evaluate/interop/serve entry points."""
    import os
    return os.path.basename(os.path.dirname(os.path.dirname(
        os.path.abspath(path))))


def parse_tag(tag: str, exp: str = "samplernn") -> ExperimentConfig:
    """Re-hydrate an ExperimentConfig from a serialized tag string.

    This is the capability generate.py relies on to rebuild the model from a
    checkpoint path (ref generate.py:126-129).
    """
    cfg = ExperimentConfig(exp=exp)
    updates = {"": {}, "model": {}, "train": {}, "data": {}}
    field_map = {key: (sub, name or key) for key, sub, name in _TAG_FIELDS}
    for part in tag.split("~"):
        if not part:
            continue
        key, _, raw = part.partition(":")
        if key not in field_map:
            continue
        sub, name = field_map[key]
        like = _get(cfg, sub, name)
        updates[sub or ""][name] = _as_type(raw, like)
    return ExperimentConfig(
        exp=updates[""].get("exp", exp),
        model=dataclasses.replace(cfg.model, **updates["model"]),
        train=dataclasses.replace(cfg.train, **updates["train"]),
        data=dataclasses.replace(cfg.data, **updates["data"]),
    )


# --------------------------------------------------------------------------
# Named presets — the five BASELINE.json configs
# --------------------------------------------------------------------------

def preset(name: str) -> ExperimentConfig:
    """Named presets covering BASELINE.json's five configs."""
    if name == "tiny_unconditional":
        # 2-tier unconditional-ish SampleRNN, 1 speaker, tiny GRU, CPU-runnable.
        return ExperimentConfig(
            exp="tiny",
            model=ModelConfig(frame_sizes=(4, 4), n_rnn=1, dim=64,
                              cond_dim=3, spk_dim=1, cond_len=16),
            train=TrainConfig(seq_len=128, batch_size=8, learning_rate=1e-3),
        )
    if name == "single_speaker_cond":
        # 3-tier conditioned SampleRNN, single speaker.
        return ExperimentConfig(
            exp="cond3",
            model=ModelConfig(frame_sizes=(4, 5, 4), n_rnn=1, dim=512, spk_dim=1),
            train=TrainConfig(seq_len=1040, batch_size=64, learning_rate=1e-4),
            data=DataConfig(static_spk=True),
        )
    if name == "samplernn":
        # Canonical multi-speaker run (ref run_samplernn.sh).
        return ExperimentConfig(
            exp="samplernn",
            model=ModelConfig(frame_sizes=(20, 4), n_rnn=2, dim=1024,
                              look_ahead=True, spk_dim=6),
            train=TrainConfig(seq_len=1040, batch_size=128, learning_rate=1e-4,
                              epoch_limit=500),
            data=DataConfig(norm_ind=False),
        )
    if name == "samplernn_gan":
        # Adversarial speaker-disentanglement head (ref run_samplegan.sh).
        return ExperimentConfig(
            exp="samplernn-gan",
            model=ModelConfig(frame_sizes=(20, 4), n_rnn=2, dim=1024,
                              look_ahead=True, spk_dim=6, weight_norm=True,
                              variant="gan", ind_cond_dim=50),
            train=TrainConfig(seq_len=1040, batch_size=64, learning_rate=1e-4,
                              scheduler=True, lambda_weight=(0.0, 0.01, 50000.0)),
            data=DataConfig(norm_ind=False),
        )
    if name == "bottleneck":
        # Bottleneck voice-conversion variant (ref run_sampleneck.sh).
        return ExperimentConfig(
            exp="bottle-neck",
            model=ModelConfig(frame_sizes=(20, 4), n_rnn=2, dim=1024,
                              look_ahead=True, spk_dim=6,
                              variant="bottleneck", ind_cond_dim=30),
            train=TrainConfig(seq_len=1040, batch_size=128, learning_rate=1e-4),
            data=DataConfig(norm_ind=False),
        )
    raise KeyError(f"unknown preset {name!r}")


PRESETS = ("tiny_unconditional", "single_speaker_cond", "samplernn",
           "samplernn_gan", "bottleneck")
