"""setup.graph_s: seconds of the program's graph build (`graph/ingest.py`
`graph_from_edges`: dedup, symmetrise, CSR) from the raw pairs, on the
harness's clock."""

MOVES = "setup_s"


def read(record):
    return record.setup.get("graph_s")
