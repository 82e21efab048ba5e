"""k1_lanes_per_pass.gen: how wide the resident sample-window kernel's passes
ran, in lanes: the lanes of every resident launch over their passes (each
launch's clusters times the most passes one of them makes), from the
counters `sample_window.lanes` and `.passes` (kernels/sample_window.py) of
every launch this process made. Nothing where the port lacks the counters or
launched no resident window. The counters are the whole process's, set-up,
warm-up and checks included: the number is the traced window's only where
every launch of the process has the window's batch, as in the cells that
list this metric."""

from msnv_tpu_torch.kernels import sample_window as sw


def read(ctx, win):
    lanes = getattr(sw.sample_window, "lanes", None)
    passes = getattr(sw.sample_window, "passes", None)
    if lanes is None or not passes:
        return None
    return lanes / passes
