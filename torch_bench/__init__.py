"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on NVIDIA
H100 cards: ``python3 torch_bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the checkout's root.

``BENCHMARK.json`` at the root names the cells; everything a cell needs is
found by name under this folder: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``limits/<cell>.json`` and one reader a
per-layer metric under ``metrics/<metric>.py``.  ``yardstick/`` holds what
later changes to the program may not move: the plain reference, the frozen
copy of the data stream it trains on, and the work and peak arithmetic.
Nothing here imports JAX or the JAX package, and the reference imports
nothing of the port.
"""
