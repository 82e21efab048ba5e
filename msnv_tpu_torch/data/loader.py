"""The port's copy of the JAX package's data/loader.py: the chunks are
numpy arrays; `device_arrays(device)` uploads the packed corpus as torch
tensors.

Streaming TBPTT chunk loader over a packed corpus.

Semantics parity with ref dataset.py:238-289 + the DataLoader wiring
(ref train.py:182, shuffle=False, drop_last=True): chunk batch `k` contains,
for every lane, the window starting at k*seq_len; `reset` is True only for
k == 0 (one hidden-state reset per epoch, ref dataset.py:259-264); the
conditioner window has the reference's one-frame offset
(`from_cond = k*cond_in_seq + 1`, ref dataset.py:261-266); the speaker label
is the majority speaker over the window (ref dataset.py:277-282).

Deviations from the reference (documented):
- whole-batch vectorized quantization (pointwise => identical values to the
  reference's per-item quantize);
- only full windows are emitted (the reference's index math can overrun lane
  ends for some corpus sizes — see corpus.py docstring);
- a `cursor` so checkpoint/resume can restart mid-epoch at an exact chunk.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np

from msnv_tpu_torch.data.corpus import Corpus
from msnv_tpu_torch.ops.quantize import uquantize_np


class Chunk(NamedTuple):
    data: np.ndarray      # (B, seq_len + overlap - 1) int32 quantized input
    reset: bool           # reset hidden state before this chunk
    target: np.ndarray    # (B, seq_len) int32 quantized targets
    cond: np.ndarray      # (B, cond_in_seq, cond_dim_eff) float32
    spk: np.ndarray       # (B,) int32 majority speaker per lane window
    index: int            # chunk index within the epoch


class ChunkLoader:
    def __init__(self, corpus: Corpus, seq_len: int, overlap_len: int,
                 cond_len: int, q_levels: int = 256, ulaw: bool = True):
        self.corpus = corpus
        self.seq_len = seq_len
        self.overlap_len = overlap_len
        self.cond_len = cond_len
        self.q_levels = q_levels
        self.ulaw = ulaw
        self.cond_in_seq = seq_len // cond_len

        lane_len = corpus.data.shape[1]
        lane_frames = corpus.cond.shape[1]
        # full windows only: window k needs samples [k*seq : k*seq+seq+ov]
        # and cond frames [k*cis+1 : (k+1)*cis+1]
        max_by_data = (lane_len - (seq_len + overlap_len)) // seq_len + 1
        max_by_cond = (lane_frames - 1) // self.cond_in_seq
        self.num_chunks = max(0, min(max_by_data, max_by_cond))

        if ulaw:
            # quantize each lane once; identical to per-window quantization
            # because uquantize is pointwise (ref dataset.py:253-254).
            # Math runs at the corpus dtype (float64) — the reference
            # quantizes f64 through torch and f32 differs at rare bin
            # boundaries (see ops.quantize.uquantize_np).
            self._qdata = uquantize_np(corpus.data.astype(np.float64),
                                       q_levels)
        else:
            self._qdata = corpus.data.astype(np.int32)

    def __len__(self) -> int:
        return self.num_chunks

    def chunk_spk(self, k: int) -> np.ndarray:
        """(B,) majority speaker per lane window (ref dataset.py:277-282)."""
        cis = self.cond_in_seq
        from_cond = k * cis + 1
        spk_window = self.corpus.spk[:, from_cond:from_cond + cis].astype(int)
        return np.array([np.argmax(np.bincount(row)) for row in spk_window],
                        dtype=np.int32)

    def get_chunk(self, k: int) -> Chunk:
        seq, ov, cis = self.seq_len, self.overlap_len, self.cond_in_seq
        start = k * seq
        data = self._qdata[:, start:start + seq + ov - 1]
        target = self._qdata[:, start + ov:start + ov + seq]
        from_cond = k * cis + 1  # one-frame offset (ref dataset.py:261-266)
        cond = self.corpus.cond[:, from_cond:from_cond + cis].astype(np.float32)
        return Chunk(data=data, reset=(k == 0), target=target, cond=cond,
                     spk=self.chunk_spk(k), index=k)

    def device_bytes(self) -> int:
        """Device footprint of device_arrays() (packed corpus, f32 cond)."""
        return (self._qdata.size * 4 + self.corpus.cond.size * 4
                + self.num_chunks * self._qdata.shape[0] * 4)

    def device_arrays(self, device, shardings=None):
        """Upload the packed corpus ONCE to `device`: {"qdata" (B, N)
        int32, "cond" (B, F, C) float32, "spk" (num_chunks, B) int32}.
        The train / eval steps then slice per-chunk tensors by chunk index
        (training/step.chunk_slices): no per-step host->device traffic.
        The majority-speaker labels are precomputed host-side into the
        (num_chunks, B) table. `shardings` (parallel/mesh.corpus_sharding)
        uploads only this rank's lanes of each array: the lane<->rank
        assignment is fixed for the epoch, as TBPTT state carry needs."""
        import torch
        spk_table = (np.stack([self.chunk_spk(k)
                               for k in range(self.num_chunks)])
                     if self.num_chunks else
                     np.zeros((0, self._qdata.shape[0]), np.int32))
        host = {
            "qdata": self._qdata.astype(np.int32),
            "cond": self.corpus.cond.astype(np.float32),
            "spk": spk_table.astype(np.int32),
        }
        if shardings is not None:
            host = {k: shardings[k].local(v) for k, v in host.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in host.items()}

    def epoch(self, start_chunk: int = 0) -> Iterator[Chunk]:
        """Iterate chunks in order; `start_chunk` supports mid-epoch resume."""
        for k in range(start_chunk, self.num_chunks):
            yield self.get_chunk(k)
