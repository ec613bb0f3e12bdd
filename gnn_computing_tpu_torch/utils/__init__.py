"""Timing, throughput accounting, profiling, autotuning and the CLI."""

from gnn_computing_tpu_torch.utils.flops import aggregation_gflops, edges_per_sec
from gnn_computing_tpu_torch.utils.timing import BenchResult, benchmark
