"""Hand-written Hopper kernels and their plain PyTorch versions.

* :mod:`.pnr_cost` — HPWL scoring (K1) and the annealing chain (K2),
  CUDA C++ in ``csrc/pnr_anneal.cu``;
* :mod:`.build` — ``nvcc`` build and ``ctypes`` loading on first use.

Importing this package builds nothing and needs no card.
"""

from .pnr_cost import anneal_chains, net_hpwl_rows

__all__ = ["anneal_chains", "net_hpwl_rows"]
