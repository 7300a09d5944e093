"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions, and
the dispatch between them (:mod:`ops`)."""
