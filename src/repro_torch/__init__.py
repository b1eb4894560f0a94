"""PyTorch/CUDA port of the distributed k-means pipeline (Balcan-Ehrlich-
Liang 2013) for NVIDIA Hopper, beside the JAX reference package ``repro``.

It imports torch, numpy and the standard library only -- never JAX and
nothing from ``repro``. Entry points run on a CUDA device unless the
caller passes ``device="cpu"``.
"""
