"""step.grad_sweep_ms: device milliseconds an iteration of the sparse step's
gradient and LLH sweep (`ops/sparse_members.py` `sparse_grad_llh`: one
member lookup per edge chunk): the span `grad_sweep` (`models/sparse.py`
`make_sparse_train_step`, timed with CUDA events on the step's stream)
over the iterations (closes of `fit_loop/sync`) of the traced window."""

from clambench import spans

MOVES = "edges_per_s"


def read(record):
    if not record.trace.device_ops:
        return None
    return spans.device_ms_per_iteration("grad_sweep")
