"""The port's on-disk memo store (``repro_torch.explore.persist``) and its
fault isolation, after ``tests/test_persist.py`` and ``tests/test_faults.py``:
checksums, quarantine, atomic writes, locking, crash-resume against the
JAX package's records, the CLI's ``--store``, ``--faults-smoke`` and
``--resume-smoke`` (on the CPU).

Tolerance: exact equality of records (the pnr and sim columns come from
exact HPWL and bit-identical move streams).
"""

import contextlib
import glob
import hashlib
import json
import os
import pickle
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from repro.explore import Explorer as RExplorer
from repro.explore.persist import _key_filename as r_key_filename
from repro_torch import faultinject
from repro_torch.errors import InjectedFault
from repro_torch.explore import DiskStore, Explorer, FileLock, ThreadSafeStore
from repro_torch.explore.__main__ import _smoke_case
from repro_torch.explore.persist import MAGIC, STORE_SCHEMA, _key_filename
from repro_torch.obs.metrics import MetricsRegistry

ROOT = Path(__file__).resolve().parents[1]
KEYS = [("mine", "abc", (2, 5)), ("pnr", ("k", 1), (4, 4)),
        ("sim", "z", (0,))]


@contextlib.contextmanager
def armed(*specs: str):
    """Arm ``site:kind:nth`` specs of the port's injection harness for a
    with-block (the state is process-global: always disarmed after)."""
    faultinject.disarm_all()
    for s in specs:
        faultinject.arm(s)
    try:
        yield
    finally:
        faultinject.disarm_all()


def _ex(store=None, metrics=None, **changes):
    apps, cfg = _smoke_case()
    if changes:
        cfg = cfg.replace(**changes)
    return apps, Explorer(apps, cfg, store=store, metrics=metrics,
                          device="cpu")


def test_key_filenames_match_reference():
    for k in KEYS:
        assert _key_filename(k) == r_key_filename(k)


def test_roundtrip_across_instances(tmp_path):
    d = str(tmp_path / "store")
    s = DiskStore(d)
    s[KEYS[0]] = [1, 2.5, "x"]
    s[KEYS[1]] = {"nested": (1, 2)}
    s[KEYS[2]] = None
    reg = MetricsRegistry()
    s2 = DiskStore(d, metrics=reg)
    assert s2[KEYS[0]] == [1, 2.5, "x"]
    assert s2[KEYS[1]] == {"nested": (1, 2)}
    assert s2[KEYS[2]] is None
    assert len(s2) == 3
    assert reg.counter("store.load") == 3
    assert reg.counter("store.quarantined") == 0


def test_atomic_write_leaves_no_tmp(tmp_path):
    d = str(tmp_path / "store")
    s = DiskStore(d)
    for i, k in enumerate(KEYS):
        s[k] = i
    assert not glob.glob(os.path.join(d, "*.tmp"))
    assert len(glob.glob(os.path.join(d, "*.entry"))) == len(KEYS)


def test_checksum_corruption_quarantined(tmp_path):
    d = str(tmp_path / "store")
    s = DiskStore(d)
    s[KEYS[0]] = "good"
    s[KEYS[1]] = "also good"
    victim = os.path.join(d, _key_filename(KEYS[0]))
    blob = bytearray(open(victim, "rb").read())
    blob[-1] ^= 0xFF                      # flip one payload byte
    open(victim, "wb").write(bytes(blob))
    reg = MetricsRegistry()
    s2 = DiskStore(d, metrics=reg)
    assert KEYS[0] not in s2              # recomputes instead of trusting
    assert s2[KEYS[1]] == "also good"     # neighbours unaffected
    assert reg.counter("store.quarantined") == 1
    qfile = os.path.join(s2.quarantine_dir, _key_filename(KEYS[0]))
    assert "checksum mismatch" in open(qfile + ".reason").read()


def test_torn_write_injection_quarantined(tmp_path):
    d = str(tmp_path / "store")
    s = DiskStore(d)
    with armed("store.write:truncate:0"):
        s[KEYS[0]] = list(range(100))     # committed, then torn
    assert s[KEYS[0]] == list(range(100))  # memory view still serves it
    reg = MetricsRegistry()
    s2 = DiskStore(d, metrics=reg)
    assert KEYS[0] not in s2
    assert reg.counter("store.quarantined") == 1
    reasons = glob.glob(os.path.join(s2.quarantine_dir, "*.reason"))
    assert reasons and "truncated payload" in open(reasons[0]).read()


def test_bad_magic_and_foreign_schema_quarantined(tmp_path):
    d = str(tmp_path / "store")
    DiskStore(d)
    with open(os.path.join(d, "garbage.entry"), "wb") as f:
        f.write(b"not a header at all\n\x00\x01")
    payload = pickle.dumps((("k",), 1))
    with open(os.path.join(d, "future.entry"), "wb") as f:
        f.write(json.dumps({
            "magic": MAGIC, "schema": STORE_SCHEMA + 1,
            "sha256": hashlib.sha256(payload).hexdigest(),
            "size": len(payload)}).encode() + b"\n" + payload)
    reg = MetricsRegistry()
    s = DiskStore(d, metrics=reg)
    assert len(s) == 0
    assert reg.counter("store.quarantined") == 2
    assert not glob.glob(os.path.join(d, "*.entry"))


def test_unpicklable_value_stays_memory_only(tmp_path):
    d = str(tmp_path / "store")
    reg = MetricsRegistry()
    s = DiskStore(d, metrics=reg)
    s[KEYS[0]] = lambda: 1
    assert KEYS[0] in s
    assert reg.counter("store.unpicklable") == 1
    assert KEYS[0] not in DiskStore(d)    # memory-only: gone on reopen


def test_delete_removes_entry_file(tmp_path):
    d = str(tmp_path / "store")
    s = DiskStore(d)
    s[KEYS[0]] = 1
    fpath = os.path.join(d, _key_filename(KEYS[0]))
    assert os.path.exists(fpath)
    del s[KEYS[0]]
    assert KEYS[0] not in s and not os.path.exists(fpath)


def test_crash_resume_bit_identical(tmp_path):
    """Stop after the pnr stage (abandon the Explorer), resume against the
    same store: the persisted stages replay from disk, and the records
    equal an uninterrupted run's and the JAX package's."""
    from repro.core.mining import MiningConfig as RMining
    from repro.explore import ExploreConfig as RConfig
    from repro.fabric import FabricOptions as ROptions, FabricSpec as RSpec
    from repro.graphir import trace_scalar as r_trace

    apps, ex0 = _ex()
    want = [r.to_dict() for r in ex0.run().records()]

    def conv4(i0, i1, i2, i3, w0, w1, w2, w3, c):
        return (((i0 * w0) + (i1 * w1)) + (i2 * w2)) + (i3 * w3) + c

    r_apps = {"conv": r_trace(
        conv4, ["i0", "i1", "i2", "i3", "w0", "w1", "w2", "w3", "c"])}
    r_cfg = RConfig(mode="per_app",
                    mining=RMining(min_support=2, max_pattern_nodes=5),
                    max_merge=2,
                    fabric=ROptions(spec=RSpec(rows=4, cols=4), chains=2,
                                    sweeps=4, simulate=True))
    assert [r.to_dict() for r in RExplorer(r_apps, r_cfg).run().records()] \
        == want

    d = str(tmp_path / "store")
    _, ex1 = _ex(store=DiskStore(d))
    ex1.pnr()                             # mine..pnr complete, then "crash"
    del ex1
    reg = MetricsRegistry()
    _, ex2 = _ex(store=DiskStore(d, metrics=reg), metrics=reg)
    assert [r.to_dict() for r in ex2.run().records()] == want
    assert ex2.metrics.counter("memo.miss.mine") == 0
    assert ex2.metrics.counter("memo.miss.pnr") == 0
    assert ex2.metrics.counter("memo.hit.pnr") > 0
    assert reg.counter("store.load") > 0
    assert reg.counter("store.quarantined") == 0
    # SimPrograms round-trip through pickle: a third explorer replays the
    # schedule and simulate entries ex2 wrote
    _, ex3 = _ex(store=DiskStore(d))
    assert [r.to_dict() for r in ex3.run().records()] == want
    assert ex3.metrics.counter("memo.miss.sched") == 0
    assert ex3.metrics.counter("memo.miss.sim") == 0


def test_filelock_mutual_exclusion(tmp_path):
    lock_path = str(tmp_path / "x.lock")
    order = []

    def worker(tag):
        with FileLock(lock_path):
            order.append((tag, "in"))
            time.sleep(0.05)
            order.append((tag, "out"))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(0, len(order), 2):
        assert order[i][0] == order[i + 1][0]
        assert order[i][1] == "in" and order[i + 1][1] == "out"


def test_filelock_not_reentrant(tmp_path):
    lk = FileLock(str(tmp_path / "x.lock"))
    with lk:
        with pytest.raises(RuntimeError):
            lk.acquire()


def test_concurrent_writers_no_corruption(tmp_path):
    d = str(tmp_path / "store")
    n_writers, n_keys = 4, 12
    errs = []

    def writer(wid):
        try:
            s = DiskStore(d)
            for i in range(n_keys):
                s[("k", i)] = {"writer": wid, "i": i,
                               "blob": list(range(200))}
        except Exception as e:       # pragma: no cover - failure path
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(w,))
               for w in range(n_writers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    reg = MetricsRegistry()
    s = DiskStore(d, metrics=reg)
    assert reg.counter("store.quarantined") == 0
    assert len(s) == n_keys
    for i in range(n_keys):
        v = s[("k", i)]
        assert v["i"] == i and v["writer"] in range(n_writers)
        assert v["blob"] == list(range(200))
    assert not glob.glob(os.path.join(d, "*.tmp"))


def test_read_through_adopts_foreign_writes(tmp_path):
    d = str(tmp_path / "store")
    rega = MetricsRegistry()
    a = DiskStore(d, metrics=rega)
    b = DiskStore(d)                         # the "other process"
    b[KEYS[0]] = {"from": "b"}
    assert KEYS[0] in a
    assert a[KEYS[0]] == {"from": "b"}
    assert rega.counter("store.readthrough") == 1
    b[KEYS[1]] = "soon corrupt"
    victim = os.path.join(d, _key_filename(KEYS[1]))
    blob = bytearray(open(victim, "rb").read())
    blob[-1] ^= 0xFF
    open(victim, "wb").write(bytes(blob))
    with pytest.raises(KeyError):
        a[KEYS[1]]
    assert rega.counter("store.quarantined") == 1


def test_thread_safe_store_facade(tmp_path):
    s = ThreadSafeStore(DiskStore(str(tmp_path / "store")))
    errs = []

    def worker(wid):
        try:
            for i in range(25):
                s[("t", wid, i)] = wid
                assert s[("t", wid, i)] == wid
                assert ("t", wid, i) in s
        except Exception as e:       # pragma: no cover - failure path
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert len(s) == 100
    del s[("t", 0, 0)]
    assert ("t", 0, 0) not in s
    assert len(list(iter(s))) == 99


# ---------------------------------------------------------------------------
# fault isolation in the port's pipeline (after tests/test_faults.py)
# ---------------------------------------------------------------------------
def test_transient_fault_absorbed_by_serial_retry():
    _, ex = _ex()
    with armed("pnr:exc:0"):
        res = ex.run()
    assert res.clean and not res.failures
    assert ex.metrics.counter("isolate.retry.pnr") == 1
    assert res.records()


def test_persistent_fault_degrades_pair_groupmates_bit_identical():
    _, clean = _ex()
    want = clean.pnr()
    _, ex = _ex()
    with armed("pnr:exc:0", "pnr.retry:exc:0"):
        got = ex.pnr()
    assert len(ex.failures) == 1
    f = ex.failures[0]
    assert f.stage == "pnr" and f.retried
    assert f.error_type == "InjectedFault"
    victim = (f.pe_name, f.app)
    assert set(got) == set(want) - {victim}
    for pair in got:
        assert got[pair].placement.coords == want[pair].placement.coords
        assert got[pair].cost == want[pair].cost


def test_on_error_raise_fails_fast():
    _, ex = _ex(on_error="raise")
    with armed("pnr:exc:0"):
        with pytest.raises(InjectedFault):
            ex.pnr()
    assert not ex.failures


def test_failures_never_memoized(tmp_path):
    d = str(tmp_path / "store")
    _, ex1 = _ex(store=DiskStore(d))
    with armed("pnr:exc:0", "pnr.retry:exc:0"):
        res1 = ex1.run()
    assert res1.failures
    _, ex2 = _ex(store=DiskStore(d))
    res2 = ex2.run()                      # no faults armed: heals
    assert res2.clean
    assert {(r.pe_name, r.app) for r in res2.records()} \
        > {(r.pe_name, r.app) for r in res1.records()
           if r.fabric_area_um2 > 0}


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def _records(path):
    with open(path) as f:
        return [ln for ln in f.read().splitlines()[1:] if ln]


def test_cli_store_matches_reference_and_resumes(tmp_path, capsys):
    from repro.explore.__main__ import main as r_main
    from repro_torch.explore.__main__ import main as t_main
    args = ["per-app", "--suite", "camera", "--fabric", "--rows", "6",
            "--cols", "6", "--chains", "2", "--sweeps", "3",
            "--min-support", "2", "--max-pattern-nodes", "4"]
    store = str(tmp_path / "store")
    assert r_main(args + ["--out", str(tmp_path / "r.jsonl")]) == 0
    assert t_main(args + ["--device", "cpu", "--store", store,
                          "--out", str(tmp_path / "a.jsonl")]) == 0
    n_entries = len(glob.glob(os.path.join(store, "*.entry")))
    assert n_entries > 0
    assert t_main(args + ["--device", "cpu", "--store", store,
                          "--metrics", str(tmp_path / "m.json"),
                          "--out", str(tmp_path / "b.jsonl")]) == 0
    want = _records(tmp_path / "r.jsonl")
    assert want and _records(tmp_path / "a.jsonl") == want
    assert _records(tmp_path / "b.jsonl") == want
    # the second run replayed every stage from the store
    counters = json.load(open(tmp_path / "m.json"))["counters"]
    assert counters.get("store.load") == n_entries
    assert not any(k.startswith("memo.miss.") and v
                   for k, v in counters.items())


def _smoke_cli(flag):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.explore",
                           flag, "--smoke-device", "cpu"],
                          capture_output=True, text=True, env=env,
                          timeout=600, cwd=str(ROOT))


def test_faults_smoke_cli_cpu():
    out = _smoke_cli("--faults-smoke")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "explore faults-smoke OK" in out.stdout


def test_resume_smoke_cli_cpu():
    out = _smoke_cli("--resume-smoke")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "explore resume-smoke OK" in out.stdout


def test_resume_smoke_mining_ignores_the_clock(monkeypatch):
    """The resume smoke's runs mine what they mine however slow the host:
    with a clock that leaps 1e6 s at every reading, mining under the
    smoke's arguments (parsed by the CLI's own parser) finds the patterns
    an unhurried run finds, where the former default budget of 15 s
    stops it before the first level."""
    import itertools
    import types

    from repro_torch.apps import image_graphs
    from repro_torch.core import mining
    from repro_torch.explore import __main__ as cli

    def mining_config(argv):
        args = cli.build_parser().parse_args(list(argv))
        return cli._config_from_args(args, "per_app").mining

    def labels(cfg):
        return [m.label for m in mining.mine_frequent_subgraphs(graph, cfg)]

    graph = image_graphs()["harris"]
    cfg = mining_config(cli.RESUME_SMOKE_ARGS)
    assert cfg.time_budget_s == float("inf")
    want = labels(cfg)
    # the smoke's arguments before the budget was lifted: the default
    i = cli.RESUME_SMOKE_ARGS.index("--mining-budget-s")
    old = mining_config(cli.RESUME_SMOKE_ARGS[:i])
    assert old.time_budget_s == 15.0 and labels(old) == want
    clock = itertools.count(0.0, 1e6)
    monkeypatch.setattr(mining, "time",
                        types.SimpleNamespace(monotonic=lambda: next(clock)))
    assert labels(cfg) == want and len(want) > 10
    assert labels(old) != want
