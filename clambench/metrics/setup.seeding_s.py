"""setup.seeding_s: seconds of the program's host seeding
(`ops/seeding.py` `conductance_seeds`, backend numpy: triangle counts,
conductance, the locally minimal ranking), on the harness's clock."""

MOVES = "setup_s"


def read(record):
    return record.setup.get("seeding_s")
