"""The TBPTT train step of a configuration with QRNN frame tiers, as
drivers/train.py runs it (the same corpus, steps, window and check), held
to the QRNN reference (reference/samplernn_qrnn.py, float32) instead of the
GRU one.

The traced window counts the fo-pool kernels' launches
(kernels/fo_pool.py's `fo_pool_forward` and `fo_pool_backward`) as
`traced_pools`, and its steps as `traced_steps`. A port without that module
counts none, and the readers of its metrics read nothing.
"""

from __future__ import annotations

import importlib

from h100_bench import inputs
from h100_bench.drivers import train
from h100_bench.reference import samplernn_qrnn as ref_qrnn


def _pool_wrappers():
    """(forward, backward) wrappers of the fo-pool kernel, or () where the
    port has none."""
    try:
        mod = importlib.import_module("msnv_tpu_torch.kernels.fo_pool")
    except ImportError:
        return ()
    return mod.fo_pool_forward, mod.fo_pool_backward


class Driver(train.Driver):
    def __init__(self, ctx):
        if not ctx.model.get("qrnn"):
            raise ValueError("the train_qrnn driver runs QRNN tiers only")
        self.pools = _pool_wrappers()
        super().__init__(ctx)

    def _counters(self):
        return sum(w.launches for w in self.pools)

    def window(self, seconds, trace_on):
        win = super().window(seconds, trace_on)
        if trace_on:
            win.raw["traced_pools"] = win.raw.pop("traced_sweeps")
            win.raw["traced_steps"] = self.ctx.traffic["traced_steps"]
        return win

    def reference(self, prec="f32", rows=None):
        """The QRNN reference's readings of the checked steps, in `prec`, on
        the first `rows` rows of each chunk (default all)."""
        n = len(self.seen["loss"])
        params0 = inputs.clone_tree(self.params0, self.ctx.device)
        chunks = [self.chunk(k) for k in range(n)]
        if rows is not None:
            chunks = [(c[0][:rows], c[1], c[2][:rows], c[3][:rows],
                       c[4][:rows]) for c in chunks]
        return ref_qrnn.train_steps(self.ctx.model, self.ctx.train, params0,
                                    chunks, prec)
