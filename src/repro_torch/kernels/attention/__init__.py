"""Flash attention: CUDA kernels for Hopper, plain versions, autograd wrapper."""
