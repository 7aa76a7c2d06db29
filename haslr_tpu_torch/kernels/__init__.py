"""Device code of the port: the row-scan NW kernels (CUDA C++ in
``csrc/``, plain PyTorch beside them) and the dense consensus engine."""
