"""step.accept_share: the share, in %, of the live rows an iteration that
took an Armijo step, over the traced window: the program's counters
`step/rows_accepted` over `step/rows` (`models/bigclam.py` `count_rows`,
from the accepted-step histogram of the dense and the sparse step). The
rows that take no step still cost the step their work."""

from clambench import spans

MOVES = "edges_per_s"


def read(record):
    rows, accepted = spans.counter("step/rows"), spans.counter("step/rows_accepted")
    if not rows or accepted is None:
        return None
    return 100.0 * accepted / rows
