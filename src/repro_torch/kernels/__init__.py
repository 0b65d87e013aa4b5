"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``), their
wrappers, their plain PyTorch versions (``ref``) and the public ops."""
