"""clonos_tpu_torch: the Clonos causal-logging dataflow on PyTorch and CUDA.

The PyTorch/CUDA counterpart of ``clonos_tpu`` (the JAX/TPU reference,
which stays as it is). The layout mirrors the reference package: each
module here is the port of the module at the same relative path there.
This package imports ``torch`` and ``numpy`` only — never ``jax`` and
never ``clonos_tpu`` (what it needs of the reference's JAX-free modules
it keeps its own copy of).

Entry points (``LocalExecutor``, ``ClusterRunner``,
``CompiledJob.init_carry``) take ``device=`` and default to ``"cuda"``:
they raise when no card is present rather than run on the CPU. The CPU
runs only when the caller passes ``device="cpu"``; every hand-written
kernel then takes its plain PyTorch version.
"""
