"""Benchmark of gnn_computing_tpu_torch, the PyTorch and CUDA port, on NVIDIA cards.

Run one cell of ``BENCHMARK.json`` from the root of a checkout:

    python3 -m portbench.run --workload gcn3.reddit-train --seed 7 --seconds 30 --trace 0

The harness is driven by data.  A cell names a configuration
(``configs/<name>.json``: the model, its widths and numeric modes) and a
traffic mix (``traffic/<name>.json``: the graph, the port's plan and the
pass).  The configuration's ``model`` picks the adapter that drives the port
(``models/<model>.py``) and the plain float64 reference that judges it
(``reference/<model>.py``).  Each per-layer metric is a reader of its own,
``metrics/<metric name>.py``, and each cell's limits of the comparison that
decides ``correct`` are ``limits/<cell name>.json``.  Nothing here imports
JAX or the JAX package.
"""
