from gnn_computing_tpu_torch.graph.csr import CSRGraph
from gnn_computing_tpu_torch.graph.io import dataset_config, load_graph, save_graph
from gnn_computing_tpu_torch.graph.reorder import degree_sort
from gnn_computing_tpu_torch.graph.synthetic import (
    community_graph,
    fixed_degree_graph,
    normal_features,
    rmat_graph,
    uniform_graph,
)

__all__ = [
    "CSRGraph",
    "community_graph",
    "dataset_config",
    "degree_sort",
    "fixed_degree_graph",
    "load_graph",
    "normal_features",
    "rmat_graph",
    "save_graph",
    "uniform_graph",
]
