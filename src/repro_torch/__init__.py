"""PyTorch/CUDA port of the CGRA PE design-space exploration system.

Beside the JAX package ``repro`` (the reference it is held against), this
package runs the paper's mine -> rank -> merge -> map flow and the fabric
place-and-route stage, with the annealing hot loop in hand-written CUDA
kernels for Hopper (:mod:`repro_torch.kernels`).  It imports neither JAX
nor ``repro``.  Entry points run on the card (``device="cuda"``) unless
the caller asks for ``device="cpu"``.
"""

__version__ = "0.1.0"
