"""Models of the port: GCN, GAT and SAGE-LSTM (the JAX package's
``models`` exports, plus the port's SAGE-LSTM names)."""

from gnn_computing_tpu_torch.models.gat import GATLayerParams, gat_forward, gat_layer, init_gat_params
from gnn_computing_tpu_torch.models.gcn import BENCH_DIMS, gcn_forward, gcn_forward_bench, gcn_layer, init_gcn_params
from gnn_computing_tpu_torch.models.sage_lstm import (
    BENCH_FEATURE_LEN,
    BENCH_NUM_NEIGHBORS,
    SageLSTM,
    SageLSTMParams,
    init_sage_lstm_params,
    sage_lstm_aggregate_bench,
    sage_lstm_layer,
)

__all__ = [
    "gcn_layer",
    "gcn_forward",
    "gcn_forward_bench",
    "init_gcn_params",
    "gat_layer",
    "gat_forward",
    "init_gat_params",
    "GATLayerParams",
    "BENCH_DIMS",
    "BENCH_FEATURE_LEN",
    "BENCH_NUM_NEIGHBORS",
    "SageLSTM",
    "SageLSTMParams",
    "init_sage_lstm_params",
    "sage_lstm_aggregate_bench",
    "sage_lstm_layer",
]
