"""The port's own copy of the JAX package's ops/interpolate.py (numpy).

Interpolation of Ahocoder lf0 / voiced-frequency tracks over unvoiced runs.

Behavioral parity target: ref interpolate.py:36-72 (``interpolation``), which
walks the signal in Python. This implementation is vectorized numpy (it is
host-side preprocessing), but reproduces the reference's exact semantics,
including its quirks:

- the voiced sample immediately *preceding* an unvoiced run is also marked
  unvoiced in the U/V mask (ref interpolate.py:62-63 sets uv[tbound0:tbound1]
  with tbound0 = t-1, the last voiced index);
- a fully-unvoiced signal is returned unchanged with an all-ones mask
  (the reference loop never fires);
- a leading unvoiced run is set to the first voiced value, a trailing run is
  held constant at the last voiced value.
"""

from __future__ import annotations

import numpy as np


def interpolation(signal: np.ndarray, unvoiced_symbol: float):
    """Linearly interpolate `signal` over unvoiced runs.

    Args:
      signal: 1-D float array.
      unvoiced_symbol: values <= this are unvoiced (-1e10 for lf0, 1e3 for gv
        — note gv marks unvoiced with a *large* sentinel but the reference
        still uses `<=` against 1e3; parity preserved).

    Returns:
      (interpolated signal float array, uv int8 mask) — same shapes as input.
    """
    signal = np.asarray(signal)
    n = signal.shape[0]
    voiced = signal > unvoiced_symbol
    uv = np.ones(signal.shape, dtype=np.int8)

    if not voiced.any() or voiced.all():
        # All-unvoiced: reference loop never triggers -> unchanged, mask ones.
        # All-voiced: nothing to interpolate.
        return np.copy(signal).astype(np.float64, copy=False), uv

    vidx = np.flatnonzero(voiced)
    isignal = np.interp(np.arange(n), vidx, signal[vidx].astype(np.float64))

    uv[~voiced] = 0
    # Leading unvoiced run: mask zero before the first voiced sample
    # (ref interpolate.py:52-55).
    uv[: vidx[0]] = 0
    # Quirk parity: a voiced sample directly followed by an unvoiced one is
    # itself masked unvoiced (ref interpolate.py:56-58 + 62-63, 69-71).
    followed_by_unvoiced = voiced[:-1] & ~voiced[1:]
    uv[:-1][followed_by_unvoiced] = 0

    return isignal, uv
