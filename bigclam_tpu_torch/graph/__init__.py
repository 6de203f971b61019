"""Graph containers, ingest and the graph store (the exports of
bigclam_tpu/graph/__init__.py)."""

from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.graph.ingest import (
    build_graph,
    dedup_directed,
    graph_from_edges,
    load_edge_list,
)
from bigclam_tpu_torch.graph.store import (
    GraphStore,
    compile_graph_cache,
    is_cache_dir,
)
from bigclam_tpu_torch.graph.stream import load_edge_list_streaming, stream_edge_list

__all__ = [
    "Graph",
    "GraphStore",
    "build_graph",
    "compile_graph_cache",
    "dedup_directed",
    "graph_from_edges",
    "is_cache_dir",
    "load_edge_list",
    "load_edge_list_streaming",
    "stream_edge_list",
]
