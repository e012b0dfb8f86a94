"""PyTorch/CUDA port of the FireBridge co-verification system.

Same sub-package layout and the same module, class and function names as
the JAX reference package, so a reader finds each counterpart.  The
modeled-time substrate (transactions, congestion, counters, registers) is
host numpy; accelerator ops run on a torch device, and every kernel is
hand-written CUDA C++ for Hopper (``kernels/csrc``), built at first use.
Entry points take an explicit ``device`` that defaults to ``"cuda"``.
"""
