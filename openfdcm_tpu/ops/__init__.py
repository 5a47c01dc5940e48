"""Hand-written accelerator kernels (Pallas).

``minplus_gpu``: the banded L2² row pass of the distance transform for
NVIDIA GPUs (Triton route), chosen over XLA's forms by measurement
(``scripts/bench_rowpass.py``, PERF.md).
"""
