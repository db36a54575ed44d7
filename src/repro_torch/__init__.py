"""PyTorch and CUDA port of the ``repro`` package, for one NVIDIA H100.

The JAX package under ``src/repro`` stays the reference: every module here
mirrors its counterpart path for path and is tested against it on the CPU
(``tests/test_torch_*.py``).  Kernels that the JAX package wrote in Pallas
for the TPU are hand-written CUDA C++ for ``sm_90a`` under ``csrc/``.

Devices are explicit: every entry point takes ``device=`` (default
``"cuda"``) and raises when there is no card, rather than falling back to
the CPU.  A kernel wrapper runs its plain PyTorch version only for tensors
that lie on the CPU.

A few public names differ from the JAX package's (``Int8Layer`` for
``IntLayer``, ``QuantConfig`` for ``QATConfig``, ``fake_quantize``,
``weight_scales``, ``int8_dense``, ``PaddedInt8Net``,
``INT8_IMPL_CHOICES``, ``ReconOutput``, ``SERVE_MODES``,
``PHANTOM_T1T2_MS``): the JAX package's dead-exports gate
(``scripts/dead_exports_allowlist.txt``) matches identifiers anywhere
under ``src/`` and ``tests/``, so reusing those names would mark the JAX
symbols as used.
"""
