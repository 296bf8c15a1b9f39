"""RWKV6 WKV: CUDA kernels for Hopper, plain versions, autograd wrapper."""
