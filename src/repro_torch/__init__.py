"""repro_torch: the PyTorch/CUDA port of ``repro`` — Double Circulant MSR
codes whose GF(p) hot path runs as hand-written Hopper kernels.

Entry points compute on the CUDA card unless the caller passes
``device="cpu"``; see :mod:`repro_torch.device`.
"""

__version__ = "0.1.0"
