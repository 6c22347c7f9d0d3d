"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100.

``python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once: set-up, a measured window,
a comparison of what the window produced against the plain float32
reference in :mod:`h100bench.reference`, and one JSON result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by its name: ``configs/<config>.json``,
``traffic/<mix>.json`` (its ``kind`` names ``drivers/<kind>.py``),
``metrics/<metric>.py`` and ``limits/<cell>.json``.
"""
