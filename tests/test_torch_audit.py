"""PyTorch port, the exactly-once audit: per-epoch digests sealed into a
ledger at every fence and re-validated after recovery (mirrors of the
reference's ``tests/test_audit.py``, without its tracer and metrics
asserts). The port's sealed ledger equals the reference's for the same
job, seed and schedule — under both packages' ``diff_ledgers`` and entry
for entry. Tolerance: exact."""

import json

import numpy as np
import pytest

from clonos_tpu.api.environment import StreamEnvironment as JaxEnv
from clonos_tpu.obs import audit as jaudit
from clonos_tpu.obs import digest as jdigest
from clonos_tpu.runtime.cluster import ClusterRunner as JaxRunner
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.causal.recovery import (AuditDivergenceError,
                                              AuditValidator)
from clonos_tpu_torch.obs import audit
from clonos_tpu_torch.obs.digest import EpochDigest, diff, diff_ledgers
from clonos_tpu_torch.runtime.cluster import ClusterRunner


@pytest.fixture(autouse=True)
def _audit_off_after():
    """Every test leaves the process-global auditors off."""
    yield
    audit.reset_audit()
    jaudit.reset_audit()


# --- digest unit tests -------------------------------------------------------

CHUNKS = {"log/0": [b"d0", b"d1"], "ring/v2": [b"r0"],
          "ring/v3": [b"r1", b"r2", b"r3"]}


def _folded(cls, order, epoch=7):
    dg = cls(epoch)
    for chan in order:
        for c in CHUNKS[chan]:
            dg.fold(chan, c)
    return dg


def test_digest_fold_interleaving_and_merge_associativity():
    a = _folded(EpochDigest, ["log/0", "ring/v2", "ring/v3"])
    b = _folded(EpochDigest, ["ring/v3", "log/0", "ring/v2"])
    assert a == b and a.combined() == b.combined() and diff(a, b) is None
    # The same folds give the reference's fingerprints, byte for byte.
    ja = _folded(jdigest.EpochDigest, ["log/0", "ring/v2", "ring/v3"])
    assert a.to_entry() == ja.to_entry()
    # Within-channel order matters.
    c = EpochDigest(7)
    c.fold("log/0", b"d1")
    c.fold("log/0", b"d0")
    for ch in ("ring/v2", "ring/v3"):
        for x in CHUNKS[ch]:
            c.fold(ch, x)
    assert c.combined() != a.combined()
    chan, reason = diff(a, c)
    assert chan == "log/0" and "fingerprint" in reason
    # Merge associativity over disjoint channel splits.
    p1, p2, p3 = (_folded(EpochDigest, [ch]) for ch in CHUNKS)
    assert p1.merge(p2).merge(p3) == p1.merge(p2.merge(p3)) == a
    with pytest.raises(ValueError, match="sharing channels"):
        p1.merge(_folded(EpochDigest, ["log/0"]))
    with pytest.raises(ValueError, match="epochs"):
        p1.merge(EpochDigest(8))


def test_digest_entry_roundtrip_and_ledger_diff():
    dg = EpochDigest(3)
    dg.fold("log/0", b"abc", 5)
    dg.fold("ring/v1", b"xyz", 2)
    dg.count_det("timestamp", 4)
    entry = dg.to_entry()
    back = EpochDigest.from_entry(json.loads(json.dumps(entry)))
    assert back == dg and back.to_entry() == entry
    assert entry["records"] == 7 and entry["epoch"] == 3
    short = EpochDigest(3)
    short.fold("log/0", b"abc", 4)
    short.fold("ring/v1", b"xyz", 2)
    assert diff(dg, short)[0] == "log/0"
    lines = diff_ledgers([entry, EpochDigest(4).to_entry()],
                         [short.to_entry()])
    assert lines == jdigest.diff_ledgers([entry, EpochDigest(4).to_entry()],
                                         [short.to_entry()])
    assert any("epoch 3" in ln and "log/0" in ln for ln in lines)
    assert any("epoch 4" in ln and "missing" in ln for ln in lines)


def test_content_sum_and_window_digest_match_the_reference():
    rng = np.random.RandomState(7)
    k, v, t = (rng.randint(-2 ** 31, 2 ** 31 - 1, 50, dtype=np.int64)
               .astype(np.int32) for _ in range(3))
    assert audit._content_sum(k, v, t) == jaudit._content_sum(k, v, t)
    window = {"logs": {0: rng.randint(0, 9, (6, 8)).astype(np.int32),
                       1: np.zeros((0, 8), np.int32)},
              "rings": {2: [(k[:10], v[:10], t[:10]), (k[:0], v[:0], t[:0])]}}
    layout = ((0, 1), (1, 1), (2, 1))
    assert audit.digest_epoch_window(5, window, layout=layout).to_entry() \
        == jaudit.digest_epoch_window(5, window, layout=layout).to_entry()


def test_null_auditor_default_and_global_switch():
    a0 = audit.get_auditor()
    assert isinstance(a0, audit.NullAuditor) and not a0.enabled
    a0.seal(EpochDigest(0))
    assert a0.ledger() == [] and a0.last_epoch == -1
    live = audit.configure_audit(on_divergence="abort")
    assert audit.get_auditor() is live and live.on_divergence == "abort"
    audit.reset_audit()
    assert not audit.get_auditor().enabled
    with pytest.raises(ValueError, match="on_divergence"):
        audit.configure_audit(on_divergence="explode")


# --- sealed ledgers, port vs reference ---------------------------------------


def _small_job(env_cls, name):
    env = env_cls(name=name, num_key_groups=8)
    (env.synthetic_source(vocab=11, batch_size=4, parallelism=2)
        .key_by()
        .window_count(num_keys=11, window_size=1 << 30)
        .sink())
    return env.build()


KW = dict(steps_per_epoch=8, log_capacity=512, max_epochs=8,
          inflight_ring_steps=32, seed=3, logical_time=True)


def _schedule(r):
    r.run_epoch(complete_checkpoint=True)
    r.run_epoch(complete_checkpoint=True)
    r.run_epoch(complete_checkpoint=False)
    r.run_epoch(complete_checkpoint=False)
    return r


@pytest.fixture(scope="module")
def ledgers(tmp_path_factory):
    port = _schedule(ClusterRunner(
        _small_job(StreamEnvironment, "aud"), device="cpu", audit=True,
        checkpoint_dir=str(tmp_path_factory.mktemp("port") / "ck"), **KW))
    ref = _schedule(JaxRunner(
        _small_job(JaxEnv, "aud"), heartbeat_timeout_s=600.0, audit=True,
        checkpoint_dir=str(tmp_path_factory.mktemp("ref") / "ck"), **KW))
    return port, ref


def test_port_ledger_equals_reference_ledger(ledgers):
    port, ref = ledgers
    pe = port.coordinator.read_ledger()
    re_ = ref.coordinator.read_ledger()
    assert [e["epoch"] for e in pe] == [0, 1, 2, 3]
    assert all(e["records"] > 0 for e in pe)
    assert diff_ledgers(re_, pe) == []
    assert jdigest.diff_ledgers(re_, pe) == []
    assert pe == re_                          # layout stamp included
    # Both wrote ledger.jsonl; the reference reads the port's file.
    from clonos_tpu.runtime.checkpoint import read_ledger_file
    assert read_ledger_file(port.coordinator.storage.ledger_path()) == re_
    assert port.auditor.epochs_sealed == 4 and port.auditor.last_epoch == 3


def test_port_epoch_window_equals_reference(ledgers):
    port, ref = ledgers
    for e in (2, 3):                           # still retained (pending)
        pw, rw = port.executor.epoch_window(e), ref.executor.epoch_window(e)
        assert sorted(pw["logs"]) == sorted(rw["logs"])
        for f in rw["logs"]:
            np.testing.assert_array_equal(pw["logs"][f], rw["logs"][f])
        assert sorted(pw["rings"]) == sorted(rw["rings"])
        for vid, steps in rw["rings"].items():
            assert len(pw["rings"][vid]) == len(steps)
            for got, want in zip(pw["rings"][vid], steps):
                for a, b in zip(got, want):
                    assert a.dtype == np.int32
                    np.testing.assert_array_equal(a, np.asarray(b))


def test_recovery_validates_replayed_epochs_against_ledger(tmp_path):
    r = _schedule(ClusterRunner(
        _small_job(StreamEnvironment, "aud"), device="cpu", audit=True,
        checkpoint_dir=str(tmp_path / "ck"), **KW))
    assert (tmp_path / "ck" / "ledger.jsonl").exists()
    r.inject_failure([2 + 1])
    report = r.recover()
    assert report.from_epoch == 2
    assert "audit" in report.phase_ms
    events = r.last_audit.events
    matches = [f for kind, f in events if kind == "recovery.audit.match"]
    assert [m["epoch"] for m in matches] == [2, 3]
    assert all(m["records"] > 0 for m in matches)
    assert not any(kind == "recovery.audit.divergence" for kind, _ in events)
    assert r.audit_stats == {"epochs-sealed": 4, "epochs-validated": 2,
                             "divergences": 0}


def test_audit_disabled_by_default_writes_no_ledger(tmp_path):
    r = ClusterRunner(_small_job(StreamEnvironment, "noaud"), device="cpu",
                      checkpoint_dir=str(tmp_path / "ck"), **KW)
    assert not r.auditor.enabled
    r.run_epoch(complete_checkpoint=True)
    r.run_epoch(complete_checkpoint=True)
    assert not (tmp_path / "ck" / "ledger.jsonl").exists()
    assert r.coordinator.read_ledger() == []
    # The process-global switch turns it on for runners built after it.
    audit.configure_audit()
    assert ClusterRunner(_small_job(StreamEnvironment, "on"), device="cpu",
                         **KW).auditor.enabled


def test_tampered_ledger_divergence_warn_and_abort(tmp_path):
    r = ClusterRunner(_small_job(StreamEnvironment, "tamper"), device="cpu",
                      checkpoint_dir=str(tmp_path / "ck"), audit=True, **KW)
    r.run_epoch(complete_checkpoint=True)
    r.run_epoch(complete_checkpoint=True)
    r.run_epoch(complete_checkpoint=False)
    entries = r.coordinator.read_ledger()
    bad = json.loads(json.dumps(entries[-1]))          # epoch 2
    first_chan = sorted(bad["channels"])[0]
    bad["channels"][first_chan]["fp"] = "00" * 8

    v = AuditValidator(r.executor, [bad], on_divergence="warn")
    assert v.validate([2]) == {"match": 0, "divergence": 1, "missing": 0}
    kind, fields = v.events[0]
    assert kind == "recovery.audit.divergence"
    assert fields["epoch"] == 2 and fields["channel"] == first_chan
    assert "fingerprint" in fields["reason"]

    va = AuditValidator(r.executor, [bad], on_divergence="abort")
    with pytest.raises(AuditDivergenceError, match=first_chan):
        va.validate([2])
    assert va.stats["divergence"] == 1
    # Epochs absent from the ledger count as missing, not divergence.
    vm = AuditValidator(r.executor, [], on_divergence="abort")
    assert vm.validate([1]) == {"match": 0, "divergence": 0, "missing": 1}
    # The untampered ledger matches.
    assert AuditValidator(r.executor, entries).validate([2])["match"] == 1
