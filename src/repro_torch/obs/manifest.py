"""Run manifests: what environment produced a performance number.

A wall-clock or kernel time is meaningless without provenance.
:func:`capture` collects that record once per process — git SHA, python,
torch, CUDA runtime and driver versions, platform, the GPU's name,
compute capability and power limit, CPU count — and the ``ExploreRecord``
jsonl files of :mod:`repro_torch.explore.records` start with it as a
header line; Chrome traces carry it under ``metadata.manifest``.

The JAX package's manifest records jax/jaxlib/XLA-cache fields instead;
the two schemas are distinct.  On a host without a card the GPU fields
read ``"none"``.
"""

from __future__ import annotations

import dataclasses
import os
import platform
import subprocess
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

__all__ = ["MANIFEST_SCHEMA", "RunManifest", "capture", "validate_manifest"]

#: bump on any field add/rename/retype; validators reject other versions
MANIFEST_SCHEMA = 1


@dataclass(frozen=True)
class RunManifest:
    """The environment fingerprint embedded in every perf artifact."""

    schema: int
    git_sha: str          # full SHA, or "unknown" outside a checkout
    python: str           # e.g. "3.12.3"
    torch: str            # torch.__version__
    cuda: str             # torch.version.cuda, or "none" (CPU build)
    driver: str           # NVIDIA driver version, or "none"
    platform: str         # platform.platform()
    device_kind: str      # torch.cuda.get_device_name(0), or "cpu"
    capability: str       # compute capability "9.0", or "none"
    power_limit: str      # nvidia-smi power.limit, e.g. "700.00 W"
    cpu_count: int

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "RunManifest":
        errors = validate_manifest(d)
        if errors:
            raise ValueError(f"invalid manifest: {'; '.join(errors)}")
        return RunManifest(**d)


def _git_sha() -> str:
    """Full commit SHA: CI env var first, then the checkout, else unknown."""
    sha = os.environ.get("GITHUB_SHA")
    if sha:
        return sha
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10, cwd=os.path.dirname(os.path.abspath(__file__)))
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return "unknown"


def _smi(field: str) -> str:
    """One ``nvidia-smi --query-gpu`` field of card 0, or "none"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={field}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "none"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "none"


def _torch_fields() -> Dict[str, str]:
    import torch
    fields = {"torch": torch.__version__,
              "cuda": torch.version.cuda or "none",
              "driver": "none", "device_kind": "cpu", "capability": "none",
              "power_limit": "none"}
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        fields.update(device_kind=torch.cuda.get_device_name(0),
                      capability=f"{major}.{minor}",
                      driver=_smi("driver_version"),
                      power_limit=_smi("power.limit"))
    return fields


_CACHED: Optional[RunManifest] = None


def capture(refresh: bool = False) -> RunManifest:
    """The process's run manifest (captured once, then cached)."""
    global _CACHED
    if _CACHED is None or refresh:
        _CACHED = RunManifest(
            schema=MANIFEST_SCHEMA,
            git_sha=_git_sha(),
            python=platform.python_version(),
            platform=platform.platform(),
            cpu_count=os.cpu_count() or 1,
            **_torch_fields())
    return _CACHED


def validate_manifest(d: Any) -> List[str]:
    """Structural validation of a manifest dict; [] when valid."""
    errors: List[str] = []
    if not isinstance(d, dict):
        return [f"manifest is {type(d).__name__}, expected a dict"]
    fields = {f.name for f in dataclasses.fields(RunManifest)}
    for name in sorted(fields - set(d)):
        errors.append(f"manifest missing field {name!r}")
    for name in sorted(set(d) - fields):
        errors.append(f"manifest has unknown field {name!r}")
    if d.get("schema") != MANIFEST_SCHEMA:
        errors.append(f"manifest schema {d.get('schema')!r}, expected "
                      f"{MANIFEST_SCHEMA}")
    if "cpu_count" in d and (not isinstance(d["cpu_count"], int)
                             or d["cpu_count"] < 1):
        errors.append(f"manifest cpu_count={d['cpu_count']!r}, expected a "
                      f"positive int")
    for name in fields - {"schema", "cpu_count"}:
        if name in d and not isinstance(d[name], str):
            errors.append(f"manifest {name}={d[name]!r}, expected a string")
    return errors
