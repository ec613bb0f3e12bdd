"""Models of the port."""

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
    "BENCH_FEATURE_LEN",
    "BENCH_NUM_NEIGHBORS",
    "SageLSTM",
    "SageLSTMParams",
    "init_sage_lstm_params",
    "sage_lstm_aggregate_bench",
    "sage_lstm_layer",
]
