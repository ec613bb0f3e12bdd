"""PyTorch/CUDA port of gnn_computing_tpu for NVIDIA Hopper.

The JAX package ``gnn_computing_tpu`` is the reference; this package mirrors
its module layout and function names so each piece can be found beside its
counterpart.  It imports torch and numpy only — never jax, never the JAX
package — and keeps its own copies of the host code it needs.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``;
on the CPU every hand-written kernel is replaced by its plain PyTorch version
(the CPU tests compare those against the JAX package).

The JAX package asks for ``Precision.HIGHEST`` on every dense transform, so
float32 matmuls and convolutions here run in full float32, never TF32.
Importing the package runs one exp on one element (see below): PyTorch's
first multi-threaded MKL VML call of a process can be inexact.
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# PyTorch's CPU exp, log and tanh on float32 call MKL's VML (ATen/cpu/vml.h)
# from every thread of a parallel_for at once.  The first such call of a
# process can leave part of its output up to 1.5e-4 relative off; the next is
# exact (torch 2.13.0+cpu, 8 threads, 11,520 elements, 6 processes at once:
# exp 14, log 12 and tanh 14 of 1,440 processes each; sigmoid and
# log_softmax, which do not go through VML, 0).  One VML call on one element,
# on the calling thread, sets VML up for all of them: 0 of 1,440 each
# (probes/first_threaded_call.py).
torch.exp(torch.zeros(1))

from gnn_computing_tpu_torch.graph.csr import CSRGraph  # noqa: E402, F401
