"""Hand-written Hopper kernels, their wrappers and their plain versions.

Importing this package builds nothing: each wrapper compiles its CUDA
source at its first launch on a CUDA tensor (:mod:`._build`).
"""
