"""Dry run of every (arch x input shape x mesh) cell, with no card.

The port of the JAX package's ``repro.launch.dryrun``.  Where the JAX
package lowers and compiles each step for a 256- or 512-device host mesh,
the port runs the step itself on meta tensors (shapes, no values) under
its shardings: a ``"fake"`` process group of 256 or 512 ranks (no
communication), ``make_production_mesh(device_type="cpu")``, every
parameter, optimizer moment, input and cache a ``DTensor`` placed by
``sharding.specs``, and the activations placed by
``activation_shard_fn``.  "ok" means the train, prefill or decode step
ran through under those shardings; its per-device FLOPs, bytes and
collective bytes are rank 0's, counted by ``launch.hlo_cost``, and
``launch.roofline`` turns them into terms against the H100's data-sheet
peaks.  ``peak_memory_bytes`` is counted, not measured: the local
arguments plus the peak of the storages the step made alive at once.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k --mesh both --out results/dryrun.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from ..configs import get_config, list_archs
from ..models.config import ArchConfig
from ..models.model import cache_shapes
from ..models.perf_flags import set_flags, set_mesh
from ..models.transformer import _build
from ..models.tree import leaves, rebuild
from ..sharding.specs import (P, activation_shard_fn, batch_axes,
                              batch_pspecs, cache_pspecs, param_pspecs,
                              to_placements)
from ..train.optimizer import AdamWConfig, OptState
from ..train.steps import (build_decode_step, build_prefill_step,
                           build_train_step)
from .hlo_cost import count
from .mesh import make_production_mesh
from .roofline import Roofline, model_flops

__all__ = ["OVERRIDES", "SHAPES", "input_specs", "lower_cell", "main"]

SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

#: per-(arch, shape) perf-flag overrides applied on top of the baseline
#: (baseline runs use an empty dict)
OVERRIDES: Dict[Tuple[str, str], Dict[str, Any]] = {}


def input_specs(cfg: ArchConfig, shape_name: str) -> Dict[str, Any]:
    """``(shape, dtype)`` stand-ins for every model input of the cell; a
    decode cell's ``cache`` is ``models.cache_shapes``'s dict."""
    info = SHAPES[shape_name]
    b, s = info["batch"], info["seq"]
    if info["kind"] in ("train", "prefill"):
        if cfg.input_mode == "embeddings":
            batch = {"inputs": ((b, s, cfg.d_model), torch.bfloat16)}
        else:
            batch = {"inputs": ((b, s), torch.int32)}
        batch["targets"] = ((b, s), torch.int32)
        if cfg.n_cross_layers:
            batch["enc"] = ((b, cfg.encoder_len, cfg.d_model),
                            torch.bfloat16)
        return batch
    # decode: one new token + caches of length seq
    if cfg.input_mode == "embeddings":
        token = ((b, cfg.d_model), torch.bfloat16)
    else:
        token = ((b,), torch.int32)
    return {"token": token,
            "cache": cache_shapes(cfg, b, s, torch.bfloat16)}


def _meta(mesh, shape, dtype, spec):
    """A meta ``DTensor`` of global ``shape`` placed by ``spec``."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(torch.empty(shape, dtype=dtype, device="meta"),
                             mesh, to_placements(mesh, spec))


def _meta_params(cfg: ArchConfig, mesh, dtype=torch.float32):
    """The parameter tree on meta, every leaf a ``DTensor`` placed by the
    trailing part of its stacked spec (``sharding.specs``)."""
    specs = param_pspecs(cfg)
    tree = _build(cfg, lambda path, name, shape: torch.empty(
        shape, dtype=dtype, device="meta"))
    out = []
    for leaf in leaves(tree):
        spec = specs
        for key in leaf.path:
            spec = spec[key]
        if leaf.index is not None:
            spec = P(*spec[1:])
        out.append(_meta(mesh, tuple(leaf.value.shape), leaf.value.dtype,
                         spec))
    return rebuild(tree, out)


def _local_bytes(*trees) -> int:
    """Bytes of the local shards of every tensor in ``trees`` (tensors,
    or trees of ``models.tree``)."""
    from torch.distributed.tensor import DTensor
    total = 0
    for t in trees:
        for x in [t] if isinstance(t, torch.Tensor) else \
                [leaf.value for leaf in leaves(t)]:
            x = x.to_local() if isinstance(x, DTensor) else x
            total += x.numel() * x.element_size()
    return total


def _fake_world(ranks: int) -> bool:
    """A ``"fake"`` process group of ``ranks`` ranks in this process,
    unless one is up already; True when this call made it."""
    if dist.is_initialized():
        if dist.get_world_size() < ranks:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is up; the cell needs {ranks}")
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)
    return True


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               microbatches: int = 1, verbose: bool = True
               ) -> Dict[str, Any]:
    t0 = time.monotonic()
    cfg = get_config(arch)
    info = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    chips = 512 if multi_pod else 256

    if shape_name == "long_500k" and not cfg.supports_long_context:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped",
                "reason": "pure full-attention arch; 500k dense KV decode "
                          "needs sub-quadratic attention (DESIGN.md §4)"}

    made = _fake_world(chips)
    try:
        from torch.distributed.tensor.experimental import \
            implicit_replication
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        set_mesh(mesh, batch_axes(multi_pod))
        shard = activation_shard_fn(mesh, cfg, multi_pod=multi_pod)
        b = info["batch"]
        params = _meta_params(cfg, mesh)
        ins = input_specs(cfg, shape_name)
        if info["kind"] == "train":
            opt_cfg = AdamWConfig()
            # moments share the param placements; step is replicated
            opt = OptState(
                step=_meta(mesh, (), torch.int32, P()),
                m=_meta_params(cfg, mesh, opt_cfg.moment_dtype),
                v=_meta_params(cfg, mesh, opt_cfg.moment_dtype))
            specs = batch_pspecs(cfg, multi_pod=multi_pod, batch=b)
            batch = {k: _meta(mesh, *ins[k], specs[k]) for k in ins}
            step = build_train_step(cfg, opt_cfg, microbatches=microbatches,
                                    shard=shard)
            args = (params, opt, batch)
        elif info["kind"] == "prefill":
            specs = batch_pspecs(cfg, multi_pod=multi_pod, batch=b)
            batch = {k: _meta(mesh, *ins[k], specs[k]) for k in ins}
            step = build_prefill_step(cfg, smax=info["seq"], shard=shard)
            args = (params, batch)
        else:
            cspecs = cache_pspecs(cfg, multi_pod=multi_pod, batch=b)
            cache = {k: _meta(mesh, *v, cspecs[k])
                     for k, v in ins["cache"].items() if k != "len"}
            cache["len"] = torch.tensor(info["seq"] - 1, dtype=torch.int32)
            bspec = batch_pspecs(cfg, multi_pod=multi_pod, batch=b)
            tok = P(*tuple(bspec["inputs"])[:len(ins["token"][0])])
            token = _meta(mesh, *ins["token"], tok)
            step = build_decode_step(cfg, shard=shard)
            args = (params, token, cache)
        arg_bytes = _local_bytes(*args)
        t_setup = time.monotonic() - t0
        with implicit_replication():
            cost, out, peak = count(step, *args)
        t_run = time.monotonic() - t0 - t_setup
    finally:
        set_mesh(None, ())
        if made:
            dist.destroy_process_group()

    rl = Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        flops_per_device=cost.flops, bytes_per_device=cost.bytes,
        collective_bytes_per_device=cost.collective_bytes,
        collective_breakdown=cost.collective_breakdown,
        model_flops=model_flops(cfg, shape_name, info["batch"], info["seq"]),
        peak_memory_bytes=float(arg_bytes + peak),
        collective_count=int(cost.collective_count))
    result = {"status": "ok", "t_setup_s": round(t_setup, 1),
              "t_run_s": round(t_run, 1), "microbatches": microbatches,
              "peak_memory": "counted (local arguments + peak of the "
                             "storages the step made), not measured",
              **rl.to_dict()}
    if verbose:
        print(rl.row())
        print(f"    peak memory (counted) {rl.peak_memory_bytes / 2**30:.2f} "
              f"GiB a rank")
        print(f"    collectives: n={rl.collective_count} "
              f"{cost.collective_breakdown}")
        print(f"    setup {t_setup:.1f}s run {t_run:.1f}s")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="perf flag override, e.g. --set attention_impl="
                         "q_outer (see models/perf_flags.py)")
    args = ap.parse_args(argv)

    if args.set:
        overrides = {}
        for kv in args.set:
            key, val = kv.split("=", 1)
            if val in ("true", "True"):
                val = True
            elif val in ("false", "False"):
                val = False
            elif val.isdigit():
                val = int(val)
            overrides[key] = val
        print(f"perf flags: {set_flags(**overrides)}")

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if args.shape is None else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = []
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                try:
                    r = lower_cell(arch, shape, multi_pod=multi,
                                   microbatches=args.microbatches)
                except Exception as e:  # a failing cell is a bug — surface it
                    r = {"arch": arch, "shape": shape,
                         "mesh": "multi" if multi else "single",
                         "status": "error", "error": f"{type(e).__name__}: {e}",
                         "traceback": traceback.format_exc()[-2000:]}
                    print(f"ERROR {arch} {shape} "
                          f"{'multi' if multi else 'single'}: "
                          f"{r['error'][:200]}")
                results.append(r)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(r) + "\n")
    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"] == "skipped")
    n_err = sum(1 for r in results if r["status"] == "error")
    print(f"\ndry-run cells: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
