"""AdamW and the gradient norm: CUDA kernels for Hopper, plain versions."""
