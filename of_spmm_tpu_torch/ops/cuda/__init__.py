"""Hand-written CUDA kernels for Hopper (sm_90a), built at first use."""
