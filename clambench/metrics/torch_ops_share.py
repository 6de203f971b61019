"""torch_ops_share: the share, in %, of the device time of the traced
window spent in operations that are not the program's hand-written CUDA
kernels (torch's own kernels, copies and fills: the torch step ops of
`ops/objective.py`, `ops/linesearch.py`, `ops/sparse_members.py` and the
loop's state copies)."""

MOVES = "edges_per_s"


def read(record):
    ops = record.trace.device_ops
    total = sum(b - a for _, a, b in ops)
    if total <= 0:
        return None
    torch_time = sum(b - a for name, a, b in ops if not record.is_port(name))
    return 100.0 * torch_time / total
