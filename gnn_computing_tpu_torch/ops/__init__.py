"""Aggregation ops: residual gather, tile product (CUDA kernel + plain version), hybrid op;
the LSTM aggregation and the per-edge MLP (plain PyTorch, no kernel).

The exports are the JAX package's ``ops`` exports under the port's names
where they differ: ``spmm_plain`` (``spmm_xla``), ``spmm_transpose``
(``spmm_transpose_xla``), ``sddmm_slots`` (``sddmm_slots_xla``) and
``bcsr_spmm_plain`` (``bcsr_spmm_xla``)."""

from gnn_computing_tpu_torch.ops.bcsr import bcsr_spmm, bcsr_spmm_plain, hybrid_spmm
from gnn_computing_tpu_torch.ops.bcsr_gat import gat_bcsr, hybrid_gat
from gnn_computing_tpu_torch.ops.edge_mlp import edge_mlp, edge_mlp_chunked
from gnn_computing_tpu_torch.ops.fused_nn import spmm_nn
from gnn_computing_tpu_torch.ops.gat import (
    add_to_center,
    att_gat,
    div_each,
    gat_aggregate,
    gat_split_forward,
    leaky_relu,
    u_add_v,
)
from gnn_computing_tpu_torch.ops.lstm import LSTMParams, init_lstm_params, lstm_aggregate, lstm_cell
from gnn_computing_tpu_torch.ops.sddmm import sddmm
from gnn_computing_tpu_torch.ops.spmm import (
    edge_values_from_slots,
    sddmm_slots,
    slots_from_edge_values,
    spmm,
    spmm_plain,
    spmm_transpose,
)

__all__ = [
    "spmm",
    "spmm_plain",
    "spmm_transpose",
    "sddmm",
    "sddmm_slots",
    "slots_from_edge_values",
    "edge_values_from_slots",
    "gat_aggregate",
    "gat_split_forward",
    "att_gat",
    "u_add_v",
    "add_to_center",
    "div_each",
    "leaky_relu",
    "bcsr_spmm",
    "bcsr_spmm_plain",
    "hybrid_spmm",
    "gat_bcsr",
    "hybrid_gat",
    "edge_mlp",
    "edge_mlp_chunked",
    "spmm_nn",
    "LSTMParams",
    "init_lstm_params",
    "lstm_aggregate",
    "lstm_cell",
]
