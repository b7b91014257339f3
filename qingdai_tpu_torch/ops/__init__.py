"""Plain tensor operators of the port; three of them dispatch to CUDA kernels."""
