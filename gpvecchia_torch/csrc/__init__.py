"""Native code of the port: the host library and the CUDA kernels."""
