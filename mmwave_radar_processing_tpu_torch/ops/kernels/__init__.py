"""Hand-written CUDA kernels of the port (sources in ``csrc/``), built at first use."""
