"""device.idle_share: the share of the traced window, in %, in which no
kernel, copy or fill ran on the card."""

MOVES = "edges_per_s"


def read(record):
    tr = record.trace
    if not tr.device_ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
