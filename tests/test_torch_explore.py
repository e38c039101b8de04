"""The port's Explorer (``device="cpu"``) against the JAX package's on the
ML suite with place-and-route on: records, dispatch counts, memoization,
the jsonl round trip, and the stages that are not ported yet.

Tolerance: exact equality of every ``ExploreRecord`` field (the pnr
columns come from integer HPWL and bit-identical move streams).  Mining
runs under a time budget far above what it needs.
"""

import dataclasses

import pytest

from repro.apps import ml_graphs as r_ml_graphs
from repro.core.mining import MiningConfig as RMining
from repro.explore import ExploreConfig as RConfig, Explorer as RExplorer
from repro.fabric import FabricOptions as ROptions, FabricSpec as RSpec
from repro_torch.apps import ml_graphs as t_ml_graphs
from repro_torch.core.mining import MiningConfig as TMining
from repro_torch.explore import (ExploreConfig as TConfig,
                                 Explorer as TExplorer, from_jsonl,
                                 read_manifest)
from repro_torch.fabric import FabricOptions as TOptions, FabricSpec as TSpec


def _cfg(Config, Mining, Options, Spec, **kw):
    return Config(mode="per_app", max_merge=2,
                  mining=Mining(min_support=3, max_pattern_nodes=4,
                                time_budget_s=600.0),
                  fabric=Options(spec=Spec(rows=8, cols=8), chains=4,
                                 sweeps=8), **kw)


@pytest.fixture(scope="module")
def runs():
    out = {}
    for batch in ("grouped", "serial"):
        ref = RExplorer(r_ml_graphs(),
                        _cfg(RConfig, RMining, ROptions, RSpec,
                             pnr_batch=batch))
        port = TExplorer(t_ml_graphs(),
                         _cfg(TConfig, TMining, TOptions, TSpec,
                              pnr_batch=batch), device="cpu")
        out[batch] = (ref, ref.run(), port, port.run())
    return out


@pytest.mark.parametrize("batch", ["grouped", "serial"])
def test_records_match_reference(runs, batch):
    ref, rres, port, pres = runs[batch]
    want = [r.to_dict() for r in rres.records()]
    got = [r.to_dict() for r in pres.records()]
    assert want and got == want
    assert all(r["fabric_wirelength"] > 0 for r in got)
    assert pres.clean and rres.clean


@pytest.mark.parametrize("batch", ["grouped", "serial"])
def test_dispatch_counts_match(runs, batch):
    ref, _, port, _ = runs[batch]
    assert port.stats["pnr_dispatch"] == ref.stats["pnr_dispatch"]
    assert port.stats["pnr"] == ref.stats["pnr"]


def test_with_config_remines_nothing(runs):
    _, _, port, pres = runs["grouped"]
    mines = port.stats["mine"]
    ex2 = port.with_config(fabric=dataclasses.replace(port.config.fabric,
                                                      sweeps=4))
    res2 = ex2.run()
    assert ex2.stats["mine"] == mines and res2.records()
    assert ex2.device == port.device


def test_jsonl_round_trip(runs, tmp_path):
    _, _, _, pres = runs["grouped"]
    path = str(tmp_path / "rows.jsonl")
    pres.to_jsonl(path)
    back = from_jsonl(path)
    assert [r.to_dict() for r in back] \
        == [r.to_dict() for r in pres.records()]
    assert read_manifest(path)["torch"]


def test_simulate_not_ported():
    cfg = _cfg(TConfig, TMining, TOptions, TSpec)
    cfg = cfg.replace(fabric=dataclasses.replace(cfg.fabric, simulate=True))
    with pytest.raises(NotImplementedError, match="simulate"):
        TExplorer(t_ml_graphs(), cfg, device="cpu").run()


def test_hierarchical_not_ported():
    cfg = _cfg(TConfig, TMining, TOptions, TSpec, pnr_mode="hierarchical")
    with pytest.raises(NotImplementedError, match="hierarchical"):
        TExplorer(t_ml_graphs(), cfg, device="cpu").pnr()
