"""PyTorch and CUDA port of the elastic trainer.

The JAX package ``repro`` is the reference; this package mirrors its module
names and state tree but imports nothing from it. Entry points run on CUDA
unless the caller asks for the CPU.
"""
import torch

# edl_paper trains in fp32 end to end: no TF32 rounding on the port's path
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
