"""The figure harness of the port (counterpart of the repo-root
``benchmarks/``): Figures 7-11 and the multi-device sweep, run as
``python -m gnn_computing_tpu_torch.benchmarks.<script>``, rows appended
to this package's ``results/``."""
