from gnn_computing_tpu_torch.graph.csr import CSRGraph
from gnn_computing_tpu_torch.graph.io import dataset_config, load_graph, save_graph
from gnn_computing_tpu_torch.graph.reorder import (
    cluster_reorder,
    cluster_reorder_exact,
    deal_shards,
    degree_sort,
    label_propagation_reorder,
)
from gnn_computing_tpu_torch.graph.synthetic import (
    community_graph,
    fixed_degree_graph,
    normal_features,
    rmat_graph,
    uniform_graph,
)

__all__ = [
    "CSRGraph",
    "cluster_reorder",
    "cluster_reorder_exact",
    "community_graph",
    "dataset_config",
    "deal_shards",
    "degree_sort",
    "fixed_degree_graph",
    "label_propagation_reorder",
    "load_graph",
    "normal_features",
    "rmat_graph",
    "save_graph",
    "uniform_graph",
]
