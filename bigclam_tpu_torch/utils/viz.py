# Copied from bigclam_tpu/utils/viz.py (its Graph is the port's graph/csr.py).
"""Visualization export (C23, SURVEY.md §2): Gephi-compatible GEXF.

The reference ships only static rendered figures (README.md:8-10 img.png /
BigClamK_1sp.png — a community-colored facebook graph drawn externally).
The equivalent capability here is a structured export: graph + per-node
community attributes in GEXF 1.2, which Gephi/Cytoscape/networkx open
directly. Pure-python writer, no dependencies.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional
from xml.sax.saxutils import escape

import numpy as np

from bigclam_tpu_torch.graph.csr import Graph


DEFAULT_MAX_NODES = 100_000
DEFAULT_MAX_EDGES = 1_000_000
_CHUNK = 65536


def export_gexf(
    path: str,
    g: Graph,
    communities: Optional[Dict[int, Iterable[int]]] = None,
    F: Optional[np.ndarray] = None,
    max_edges: Optional[int] = DEFAULT_MAX_EDGES,
    max_nodes: Optional[int] = DEFAULT_MAX_NODES,
) -> None:
    """Write the graph (undirected, deduped) with community attributes.

    Per node: `community` = its primary community (argmax F when F given,
    else the first community containing it; -1 when none) and
    `n_communities` = overlap count.

    GEXF is a per-element XML format for interactive viewers — useless (and
    enormous) at the graph sizes this framework trains on — so output is
    bounded by default: the first `max_nodes` node ids and the `max_edges`
    first CSR-order edges among them (pass None to lift either bound
    explicitly). Rows are rendered in chunked ''.join batches, not one
    f-string write per element (round-1/2 perf finding).
    """
    n = g.num_nodes
    primary = np.full(n, -1, dtype=np.int64)
    overlap = np.zeros(n, dtype=np.int64)
    if communities is not None:
        for cid in sorted(communities):
            members = np.asarray(list(communities[cid]), dtype=np.int64)
            overlap[members] += 1
            unset = members[primary[members] == -1]
            primary[unset] = cid
    if F is not None:
        has_mass = np.asarray(F).max(axis=1) > 0
        primary[has_mass] = np.asarray(F).argmax(axis=1)[has_mass]
    n_out = n if max_nodes is None else min(n, max_nodes)
    und = (g.src < g.dst) & (g.dst < n_out)   # one direction, kept nodes
    src, dst = g.src[und], g.dst[und]
    if max_edges is not None and src.size > max_edges:
        src, dst = src[:max_edges], dst[:max_edges]
    with open(path, "w") as f:
        f.write(
            '<?xml version="1.0" encoding="UTF-8"?>\n'
            '<gexf xmlns="http://gexf.net/1.2" version="1.2">\n'
            '  <graph defaultedgetype="undirected">\n'
            '    <attributes class="node">\n'
            '      <attribute id="0" title="community" type="long"/>\n'
            '      <attribute id="1" title="n_communities" type="long"/>\n'
            "    </attributes>\n    <nodes>\n"
        )
        for lo in range(0, n_out, _CHUNK):
            hi = min(lo + _CHUNK, n_out)
            f.write(
                "".join(
                    f'      <node id="{u}" label="{escape(str(u))}">'
                    f'<attvalues><attvalue for="0" value="{primary[u]}"/>'
                    f'<attvalue for="1" value="{overlap[u]}"/></attvalues>'
                    "</node>\n"
                    for u in range(lo, hi)
                )
            )
        f.write("    </nodes>\n    <edges>\n")
        for lo in range(0, src.size, _CHUNK):
            hi = min(lo + _CHUNK, src.size)
            s_c, d_c = src[lo:hi].tolist(), dst[lo:hi].tolist()
            f.write(
                "".join(
                    f'      <edge id="{i}" source="{s}" target="{d}"/>\n'
                    for i, (s, d) in enumerate(zip(s_c, d_c), start=lo)
                )
            )
        f.write("    </edges>\n  </graph>\n</gexf>\n")
