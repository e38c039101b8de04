"""Time-domain subsystem: modulo scheduling + cycle-accurate simulation.

The static DSE pipeline (mine -> merge -> map -> place -> route) prices a
design; this subsystem *executes* it over time:

* :mod:`repro_torch.sim.schedule` — iterative modulo scheduler assigning every
  PE instance, I/O stream, and routed hop a (cycle, II) slot, with the
  achieved initiation interval reported against the recurrence/resource
  minimum;
* :mod:`repro_torch.sim.cycle` — cycle-accurate functional simulator
  running all tiles in lockstep, batched over programs and input sets, the
  whole cycle loop of a bucket in one launch of the cycle-stepper kernel
  (:mod:`repro_torch.kernels.sim_step`, K3) on the card, or its plain
  PyTorch version on the CPU;
* :mod:`repro_torch.sim.golden` — bit-exact verification of simulated
  outputs against :func:`repro_torch.graphir.interp.interpret`.

Quick start (``device="cuda"`` by default; ``"cpu"`` for the plain
versions)::

    from repro_torch.sim import build_sim, simulate, verify_mapping
    prog, pnr = build_sim(dp, mapping, app, FabricSpec(rows=8, cols=8))
    print(prog.summary())                    # II, latency, tiles, wires
    print(verify_mapping(dp, mapping, app).row())
"""

from .cycle import (SimProgram, SimResult, lower_program, sim_signature,
                    simulate, simulate_batch)
from .golden import (GoldenReport, build_sim, build_sim_batch,
                     check_against_interp, compare_with_interp,
                     random_inputs, verify_mapping)
from .schedule import (ModuloSchedule, fabric_signature, min_ii,
                       modulo_schedule, modulo_schedule_batch, route_timing)

__all__ = [
    "SimProgram", "SimResult", "lower_program", "sim_signature", "simulate",
    "simulate_batch", "GoldenReport", "build_sim", "build_sim_batch",
    "check_against_interp", "compare_with_interp", "random_inputs",
    "verify_mapping", "ModuloSchedule", "fabric_signature", "min_ii",
    "modulo_schedule", "modulo_schedule_batch", "route_timing",
]
