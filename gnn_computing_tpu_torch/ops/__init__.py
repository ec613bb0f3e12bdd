"""Aggregation ops: residual gather, tile product (CUDA kernel + plain version), hybrid op;
the LSTM aggregation and the per-edge MLP (plain PyTorch, no kernel)."""

from gnn_computing_tpu_torch.ops.edge_mlp import edge_mlp, edge_mlp_chunked
from gnn_computing_tpu_torch.ops.lstm import LSTMParams, init_lstm_params, lstm_aggregate, lstm_cell

__all__ = [
    "edge_mlp",
    "edge_mlp_chunked",
    "LSTMParams",
    "init_lstm_params",
    "lstm_aggregate",
    "lstm_cell",
]
