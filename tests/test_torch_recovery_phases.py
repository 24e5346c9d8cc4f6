"""PyTorch port, the overlapped recovery finalize, the shared routed-window
cache and standby-host bootstrap: mirrors of the reference's
``tests/test_recovery_phases.py`` (and its bootstrap and route-cache cases
in ``tests/test_recovery.py``) on the same small jobs and seeds. Carries
are compared leaf for leaf, exactly; ``finalize.*`` attributions are held
to the reference's key sets and to inequalities that hold by
construction, never to a wall-clock tolerance."""

import json
import threading

import jax
import numpy as np
import pytest

from clonos_tpu.api.environment import StreamEnvironment as JaxEnv
from clonos_tpu.runtime import executor as jex
from clonos_tpu.runtime.cluster import ClusterRunner as JaxRunner
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.causal import recovery as rec
from clonos_tpu_torch.convert import carry_to_numpy
from clonos_tpu_torch.obs import audit
from clonos_tpu_torch.runtime import executor as tex
from clonos_tpu_torch.runtime.cluster import ClusterRunner
from clonos_tpu_torch.utils.tree import tree_leaves

KW = dict(steps_per_epoch=8, log_capacity=512, max_epochs=8,
          inflight_ring_steps=32, seed=3, logical_time=True)


@pytest.fixture(autouse=True)
def _audit_off_after():
    yield
    audit.reset_audit()


def _window_job(env_cls, name):
    env = env_cls(name=name, num_key_groups=8)
    (env.synthetic_source(vocab=11, batch_size=4, parallelism=2)
        .key_by()
        .window_count(num_keys=11, window_size=1 << 30)
        .sink())
    return env.build()


def _port(name="ph", job=_window_job, **kw):
    return ClusterRunner(job(StreamEnvironment, name), device="cpu",
                         **dict(KW, **kw))


def _ref(name="ph", job=_window_job, **kw):
    return JaxRunner(job(JaxEnv, name), heartbeat_timeout_s=600.0,
                     **dict(KW, **kw))


def _canon(runner):
    if isinstance(runner, JaxRunner):
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(
            jax.device_get(jex.canonical_carry(runner.executor.carry)))]
    return tree_leaves(carry_to_numpy(
        tex.canonical_carry(runner.executor.carry)))


def _assert_leaves_equal(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, f"{what} {i}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what} leaf {i}")


def _finalize_keys(pm):
    return {k for k in pm if k.startswith("finalize")}


def _check_finalize_attribution(pm):
    """By construction: overlapped, ``finalize`` is the wall after the
    audit's share and the credit is what barrier + verify exceed it by;
    sequential, barrier and verify are disjoint parts of ``finalize``."""
    subs = {k: v for k, v in pm.items()
            if k.startswith("finalize.") and k != "finalize.overlap-saved"}
    saved = pm.get("finalize.overlap-saved", 0.0)
    assert saved >= 0.0
    assert min(subs.values()) >= 0.0
    assert sum(subs.values()) - saved <= pm["finalize"] + 1e-6


def _two_epochs(r):
    r.run_epoch(complete_checkpoint=True)
    r.run_epoch(complete_checkpoint=False)
    return r


def test_overlapped_and_sequential_finalize_agree():
    """The same kill recovered with the overlapped finalize (the default)
    and with ``overlap_finalize=False``: equal carries, equal to the
    reference's, and the reference's ``finalize.*`` key sets per mode."""
    runs = {}
    for tag, make, overlap in (("ovl", _port, None), ("seq", _port, False),
                               ("ref_ovl", _ref, None),
                               ("ref_seq", _ref, False)):
        r = _two_epochs(make())
        r.inject_failure([2 + 1])
        report = r.recover(overlap_finalize=overlap)
        runs[tag] = (r, report)
    _assert_leaves_equal(_canon(runs["ovl"][0]), _canon(runs["seq"][0]),
                         "overlapped vs sequential finalize")
    _assert_leaves_equal(_canon(runs["ovl"][0]), _canon(runs["ref_ovl"][0]),
                         "port vs reference")
    pm, cm = runs["ovl"][1].phase_ms, runs["seq"][1].phase_ms
    assert "finalize.overlap-saved" in pm
    assert "finalize.overlap-saved" not in cm
    assert _finalize_keys(pm) == _finalize_keys(runs["ref_ovl"][1].phase_ms)
    assert _finalize_keys(cm) == _finalize_keys(runs["ref_seq"][1].phase_ms)
    for m in (pm, cm):
        _check_finalize_attribution(m)
    for f in ("steps_replayed", "records_replayed", "determinants_replayed"):
        assert getattr(runs["ovl"][1], f) == getattr(runs["seq"][1], f) \
            == getattr(runs["ref_ovl"][1], f), f
    snap = runs["ovl"][0].metrics.snapshot()
    assert snap["job.ph.recovery.finalize.barrier-read-ms"]["count"] == 1
    assert snap["job.ph.recovery.records-replayed"] \
        == runs["ref_ovl"][0].metrics.snapshot()[
            "job.ph.recovery.records-replayed"]


def test_overlap_verify_failure_keeps_subtasks_dead_and_retryable():
    """Revive runs only after the barrier join and the state verify: a
    deferred assert that trips leaves the subtask dead and the heartbeat
    table marking it, the barrier thread gone, and a retry succeeds —
    ending where the reference's retry of the same failure ends."""
    flat = 2 + 1
    runs = []
    for make, err in ((_port, rec.RecoveryError),
                      (_ref, RuntimeError)):
        r = _two_epochs(make("phdead"))
        orig = r._ring_bounds_dev
        assert orig() is not None
        r.inject_failure([flat])
        # Skew the ring-bounds lanes of the packed read: routing used the
        # (valid) host mirror, so only the final verify fires.
        r._ring_bounds_dev = lambda orig=orig: orig() + 1
        with pytest.raises(err, match="state suspect"):
            r.recover()
        assert flat in r.failed and flat in r.heartbeats._dead
        assert not any(t.name == "recovery-finalize-barrier"
                       for t in threading.enumerate())
        r._ring_bounds_dev = orig
        report = r.recover()
        assert not r.failed and flat not in r.heartbeats._dead
        assert "finalize.state-verify" in report.phase_ms
        runs.append(r)
    _assert_leaves_equal(_canon(runs[0]), _canon(runs[1]),
                         "retried recovery vs reference")


def test_overlap_audit_divergence_deferred_past_verify(tmp_path):
    """An audit divergence under the abort policy in overlapped mode does
    not cut the window short: the barrier joins, the state verify runs,
    revive keeps its place, then AuditDivergenceError propagates."""
    audit.configure_audit(on_divergence="abort")
    r = _two_epochs(_port("phaud", audit=True,
                          checkpoint_dir=str(tmp_path / "ck")))
    ledger = tmp_path / "ck" / "ledger.jsonl"
    entries = [json.loads(ln) for ln in ledger.read_text().splitlines()
               if ln]
    for e in entries:
        for ch in e["channels"].values():
            ch["fp"] = "00" * 8
    ledger.write_text("".join(json.dumps(e) + "\n" for e in entries))
    order = []
    verify = r._verify_final
    r._verify_final = lambda *a: (order.append("verify"), verify(*a))[1]
    flat = 2 + 1
    r.inject_failure([flat])
    with pytest.raises(rec.AuditDivergenceError):
        r.recover()
    assert order == ["verify"]
    assert not r.failed and flat not in r.heartbeats._dead
    assert r.audit_stats["divergences"] == 1
    assert not any(t.name == "recovery-finalize-barrier"
                   for t in threading.enumerate())


def _wc_job(env_cls, name):
    env = env_cls(name=name, num_key_groups=16)
    (env.synthetic_source(vocab=11, batch_size=8, parallelism=2)
        .key_by().window_count(num_keys=11, window_size=50).sink())
    return env.build()


def test_same_vertex_pair_hits_the_route_cache():
    """Both window subtasks fail together: the routed windows are shared
    between them (as many cache hits as the reference), and the recovery
    is bit-identical to a run that never failed."""
    kw = dict(steps_per_epoch=3, inflight_ring_steps=16, max_epochs=16,
              log_capacity=1 << 12)
    golden, port, ref = (make("rc", job=_wc_job, **kw)
                         for make in (_port, _port, _ref))
    for r in (golden, port, ref):
        r.run_epoch()
        r.step()
        r.step()
    port.inject_failure([2, 3])
    ref.inject_failure([2, 3])
    port.recover()
    ref.recover()
    assert port._route_cache_hits > 0
    assert port._route_cache_hits == ref._route_cache_hits
    _assert_leaves_equal(_canon(port), _canon(golden), "port vs golden")
    _assert_leaves_equal(_canon(port), _canon(ref), "port vs reference")
    # A single failed subtask routes its own lane: no sharing.
    port.inject_failure([3])
    port.recover()
    assert port._route_cache_hits == 0


def _mirror_rows(logs_rows, heads, tails):
    cap = logs_rows.shape[1]
    out = {}
    for f in range(logs_rows.shape[0]):
        pos = np.arange(int(tails[f]), int(heads[f])) & (cap - 1)
        out[f] = (logs_rows[f][pos], int(tails[f]))
    return out


def test_bootstrap_standby_equals_the_reference_bootstrap(tmp_path):
    """The whole job rebuilt on a fresh runner from the durable
    checkpoint and the reference runner's mirrored determinant rows: the
    port's rebuilt carry equals the reference's rebuilt carry and the
    dead runner's, and both continue identically."""
    kw = dict(KW, steps_per_epoch=4)
    ref = JaxRunner(_window_job(JaxEnv, "boot"), heartbeat_timeout_s=600.0,
                    checkpoint_dir=str(tmp_path / "ref"), **kw)
    dead = ClusterRunner(_window_job(StreamEnvironment, "boot"),
                         checkpoint_dir=str(tmp_path / "port"),
                         device="cpu", **kw)
    for r in (ref, dead):
        for _ in range(3):
            r.run_epoch(complete_checkpoint=True)
        r.run_epoch(complete_checkpoint=False)
    logs = ref.executor.carry.logs
    mirror = _mirror_rows(np.asarray(logs.rows), np.asarray(logs.head),
                          np.asarray(logs.tail))
    jb, jreport = JaxRunner.bootstrap_standby(
        _window_job(JaxEnv, "boot"), str(tmp_path / "ref"), mirror,
        heartbeat_timeout_s=600.0, **kw)
    tb, treport = ClusterRunner.bootstrap_standby(
        _window_job(StreamEnvironment, "boot"), str(tmp_path / "port"),
        mirror, device="cpu", **kw)
    assert treport.steps_replayed == jreport.steps_replayed == 4
    assert treport.from_epoch == jreport.from_epoch == 3
    assert tb.global_step == jb.global_step == 16
    _assert_leaves_equal(_canon(tb), _canon(jb), "port vs reference rebuild")
    _assert_leaves_equal(_canon(tb), _canon(dead), "rebuild vs dead runner")
    pm = treport.phase_ms
    assert _finalize_keys(pm) == _finalize_keys(jreport.phase_ms)
    assert {"finalize.state-rehydrate", "finalize.ring-reregister",
            "finalize.listener-reattach", "finalize.edge-rehydrate",
            "finalize.first-step-recompile", "finalize.barrier-read",
            "finalize.state-verify", "finalize.overlap-saved"} \
        <= set(pm)
    assert min(v for k, v in pm.items() if k.startswith("finalize")) >= 0
    assert tb.executor.roll_gap_async == jb.executor.roll_gap_async
    assert tb.executor.async_counts == jb.executor.async_counts
    # The host RNG sits past the replayed prefix: the next epoch draws
    # what the dead runner would have.
    for r in (tb, jb, dead):
        r.run_epoch(complete_checkpoint=True)
    _assert_leaves_equal(_canon(tb), _canon(jb), "next epoch vs reference")
    _assert_leaves_equal(_canon(tb), _canon(dead), "next epoch vs dead")


def test_bootstrap_standby_refuses_rebalance_and_missing_rows(tmp_path):
    env = StreamEnvironment(name="rb", num_key_groups=8)
    env.synthetic_source(vocab=7, batch_size=4, parallelism=2) \
        .rebalance().sink(parallelism=2)
    with pytest.raises(rec.RecoveryError, match="rebalance"):
        ClusterRunner.bootstrap_standby(env.build(), str(tmp_path), {},
                                        device="cpu")
    r = _port("boot2", checkpoint_dir=str(tmp_path / "ck"),
              steps_per_epoch=4)
    r.run_epoch(complete_checkpoint=True)
    with pytest.raises(rec.RecoveryError, match="mirror rows missing"):
        ClusterRunner.bootstrap_standby(
            _window_job(StreamEnvironment, "boot2"), str(tmp_path / "ck"),
            {0: (np.zeros((0, 8), np.int32), 0)}, device="cpu",
            **dict(KW, steps_per_epoch=4))
