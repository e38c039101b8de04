"""Hand-written Hopper kernels and their plain PyTorch versions.

* :mod:`.pnr_cost` — HPWL scoring and the annealing chain (K2, whose
  prologue scores every chain's start: the reference's K1), CUDA C++ in
  ``csrc/pnr_anneal.cu``, and the reference's ``hpwl_pallas``,
  ``hpwl_batched`` and ``hpwl_delta_pallas`` on it;
* :mod:`.sim_step` — the simulator's ALU step and the cycle stepper (K3),
  CUDA C++ in ``csrc/sim_step.cu``, and the reference's ``alu_step_jnp``
  and ``alu_step_pallas``;
* :mod:`.tiling` — bucket padding, and the reference's tile helpers;
* :mod:`.sharded` — K6, K7 and the Mamba conv on ``DTensor``s, K6 and K7
  on meta tensors;
* :mod:`.pe_fused` — the generated fused-PE kernel (K4), Triton code
  generated per pattern;
* :mod:`.gemm` — the matmul with a fused PE epilogue (K5), CUDA C++ in
  ``csrc/gemm_pe.cu``;
* :mod:`.flash_attention` — flash attention (K6), CUDA C++ in
  ``csrc/flash_attention.cu``;
* :mod:`.mamba_scan` — the selective scan (K7), CUDA C++ in
  ``csrc/mamba_scan.cu``;
* :mod:`.ops` — ``fused_pe_apply``, ``attention``, ``selective_scan`` and
  ``matmul_fused``; :mod:`.ref` — their oracles;
* :mod:`.build` — ``nvcc`` build and ``ctypes`` loading on first use.

Importing this package builds nothing, imports no ``triton`` and needs no
card.
"""

from .flash_attention import flash_attention
from .gemm import gemm_pe
from .mamba_scan import mamba_scan
from .ops import attention, fused_pe_apply, matmul_fused, selective_scan
from .pe_fused import kernel_from_config, make_pe_kernel
from .pnr_cost import anneal_chains
from .sim_step import simulate_batch_stepper

__all__ = ["anneal_chains", "simulate_batch_stepper",
           "fused_pe_apply", "matmul_fused", "make_pe_kernel",
           "kernel_from_config", "gemm_pe", "attention", "selective_scan",
           "flash_attention", "mamba_scan"]
