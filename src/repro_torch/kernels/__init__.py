"""Hand-written Hopper kernels and their plain PyTorch versions.

* :mod:`.pnr_cost` — HPWL scoring (K1) and the annealing chain (K2),
  CUDA C++ in ``csrc/pnr_anneal.cu``;
* :mod:`.sim_step` — the simulator's ALU step and the cycle stepper (K3),
  CUDA C++ in ``csrc/sim_step.cu``;
* :mod:`.build` — ``nvcc`` build and ``ctypes`` loading on first use.

Importing this package builds nothing and needs no card.
"""

from .pnr_cost import anneal_chains, net_hpwl_rows
from .sim_step import simulate_batch_stepper

__all__ = ["anneal_chains", "net_hpwl_rows", "simulate_batch_stepper"]
