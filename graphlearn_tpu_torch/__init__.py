"""graphlearn_tpu_torch: the PyTorch + CUDA (Hopper) port of
graphlearn_tpu.

This package imports torch and never JAX, nor anything of the JAX
package.  Its entry points run on the card (``device='cuda'``) unless
the caller asks for the CPU, and raise when CUDA is missing.  Kernels
are CUDA C++ under ``csrc/``, built with ``nvcc`` on first use; on
CUDA tensors a kernel wrapper launches its kernel or raises, and only
tensors on the CPU take the plain PyTorch version.

Ported so far: the online serving path — `data.Dataset` (CSR graph +
device feature table), `loader.expand_tree_levels` over the one-hop
sampler kernel, the fused row-gather kernel, `models.TreeSAGE`, and
`serving.ServingEngine` / `ServingFrontend`.
"""
from . import data, loader, models, ops, serving, utils

__version__ = '0.1.0'
