"""PyTorch port, the persistent kernel build cache and the warm standby
(``clonos_tpu/utils/compile_cache.py``, ``ClusterRunner.prewarm_recovery``,
``LocalExecutor.first_step_inputs``): cache namespaces equal the
reference's keys and never collide; two fresh interpreters sharing one
cache directory build once (the codec library lands there and is not
rebuilt); ``aot_lower_first_step`` moves no live state and fails loudly
under the reference's names; ``first_step_inputs`` has the reference's
shapes (and a feed job's the shapes ``_pull_feeds`` returns); a
prewarmed runner recovers bit-identically to the port's golden run and
the reference's runner, on one process and on two gloo ranks, and its
ledger equals an unwarmed one's; ``bootstrap_standby`` with a cache
directory equals the reference's bootstrap. Inputs come from seeds and
fixed time sequences; every comparison is exact.

The rank functions live here and import only the port: the ranks import
this module as ``tests.test_torch_compile_cache``."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.causal import recovery as rec
from clonos_tpu_torch.convert import carry_to_numpy
from clonos_tpu_torch.obs import trace as obs
from clonos_tpu_torch.ops import cuda_build
from clonos_tpu_torch.parallel import distributed as dist_
from clonos_tpu_torch.runtime import executor as tex
from clonos_tpu_torch.runtime.cluster import ClusterRunner
from clonos_tpu_torch.utils.compile_cache import (aot_lower_first_step,
                                                  enable_compile_cache,
                                                  sharding_cache_key)
from clonos_tpu_torch.utils.tree import tree_leaves

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HERE = "tests.test_torch_compile_cache"
RANK_TIMEOUT_S = 240
TIMES = list(range(0, 400, 20))
KW = dict(steps_per_epoch=8, log_capacity=512, max_epochs=8,
          inflight_ring_steps=32, seed=3, logical_time=True)


@pytest.fixture(autouse=True)
def _restore_process_globals():
    """Each test leaves the build directory and the tracers as it found
    them (a runner built with ``compile_cache_dir`` re-points the build
    directory for the whole process)."""
    prev = cuda_build.build_dir()
    yield
    cuda_build.set_build_dir(prev)
    obs.reset()
    from clonos_tpu.obs import trace as jobs
    jobs.reset()


def _wc_job(env_cls, parallelism=2):
    """The reference's ``tests/test_recovery.py`` job."""
    env = env_cls(name="wc", num_key_groups=16)
    (env.synthetic_source(vocab=11, batch_size=8, parallelism=parallelism)
        .key_by()
        .window_count(num_keys=11, window_size=50)
        .sink())
    return env.build()


def _headline_job(env_cls, parallelism=4):
    """The headline's topology at a small width: sources -> keyBy ->
    windows -> keyBy (static route) -> reduces -> sinks."""
    env = env_cls(name="hl", num_key_groups=16, default_edge_capacity=64)
    (env.synthetic_source(vocab=37, batch_size=8, parallelism=parallelism)
        .key_by().window_count(num_keys=37, window_size=4)
        .key_by().reduce(num_keys=37).sink())
    return env.build()


def _port_wc(**kw):
    r = ClusterRunner(_wc_job(StreamEnvironment), steps_per_epoch=3,
                      heartbeat_timeout_s=0.05, seed=3, device="cpu", **kw)
    r.executor.time_source.now = lambda it=iter(TIMES): next(it)
    return r


def _ref_wc(**kw):
    from clonos_tpu.api.environment import StreamEnvironment as JEnv
    from clonos_tpu.runtime.cluster import ClusterRunner as JRunner
    r = JRunner(_wc_job(JEnv), steps_per_epoch=3, heartbeat_timeout_s=600.0,
                seed=3, **kw)
    r.executor.time_source.now = lambda it=iter(TIMES): next(it)
    return r


def _canon(runner):
    if isinstance(runner, ClusterRunner):
        return tree_leaves(carry_to_numpy(
            tex.canonical_carry(runner.executor.carry)))
    from clonos_tpu.runtime import executor as jex
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.device_get(jex.canonical_carry(runner.executor.carry)))]


def _eq(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, f"{what} {i}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what} leaf {i}")


def _live(runner):
    """Everything a warm must not move: the carry, the step counters, the
    step-input ledger and the host RNG's state."""
    ex = runner.executor
    st = ex._rng.get_state()
    return ([x.clone() for x in tree_leaves(ex.carry)],
            (runner.global_step, ex._steps_executed, ex.step_in_epoch,
             ex.epoch_id), list(ex.step_input_history),
            (st[0], st[1].copy(), st[2], st[3], st[4]))


def _assert_live_equal(a, b):
    assert len(a[0]) == len(b[0])
    for x, y in zip(a[0], b[0]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert a[1:3] == b[1:3]
    assert a[3][0] == b[3][0] and a[3][2:] == b[3][2:]
    np.testing.assert_array_equal(a[3][1], b[3][1])


# --- namespaces --------------------------------------------------------------

def test_sharding_cache_key_namespaces_match_the_reference(tmp_path):
    """``tests/test_distributed.py:85-106`` and
    ``test_sharded_and_unsharded_namespaces_never_collide`` on the port:
    the bare key in both packages, a one-rank CPU mesh's mesh part equal
    to the reference's, and three distinct directories under one root."""
    from clonos_tpu.parallel import distributed as jdist
    from clonos_tpu.utils.compile_cache import sharding_cache_key as jkey
    assert sharding_cache_key() == jkey() == "nomesh-nospec"
    m1 = dist_.task_mesh(max_devices=1, device="cpu")
    k1 = sharding_cache_key(mesh=m1)
    assert k1 != "nomesh-nospec"
    assert k1.split("-")[0] == jkey(
        mesh=jdist.task_mesh(max_devices=1)).split("-")[0]
    assert sharding_cache_key(mesh=m1) == k1
    specs = tex.CompiledJob(_wc_job(StreamEnvironment),
                            log_capacity=256, max_epochs=8,
                            inflight_ring_steps=16).placements()
    k2 = sharding_cache_key(mesh=m1, specs=specs)
    assert len({"nomesh-nospec", k1, k2}) == 3

    root = str(tmp_path / "ns")
    bare = enable_compile_cache(root)
    assert bare == root and cuda_build.build_dir() == tmp_path / "ns"
    meshed = enable_compile_cache(root, mesh=m1)
    assert meshed == os.path.join(root, k1)
    refined = enable_compile_cache(root, mesh=m1, specs=specs)
    assert refined == os.path.join(root, k2)
    assert len({bare, meshed, refined}) == 3
    assert all(os.path.isdir(d) for d in (bare, meshed, refined))
    assert cuda_build.build_dir() == tmp_path / "ns" / k2
    assert cuda_build.library_path("keyed_hist.cu").parent == \
        tmp_path / "ns" / k2


def test_runner_points_builds_at_its_cache_dir(tmp_path):
    """``compile_cache_dir=`` re-points every later build before the
    executor is built; the runner keeps the directory it chose."""
    from clonos_tpu_torch.ops import native
    r = ClusterRunner(_wc_job(StreamEnvironment), device="cpu",
                      compile_cache_dir=str(tmp_path / "cc"), **KW)
    assert r._compile_cache_dir == str(tmp_path / "cc")
    assert cuda_build.build_dir() == tmp_path / "cc"
    assert native.library_path().parent == tmp_path / "cc"
    assert ClusterRunner(_wc_job(StreamEnvironment), device="cpu",
                         **KW)._compile_cache_dir is None


_CODEC = r"""
import json, os, sys
from pathlib import Path
from clonos_tpu_torch.ops import cuda_build, native
from clonos_tpu_torch.utils.compile_cache import enable_compile_cache
enable_compile_cache(sys.argv[1])
print(json.dumps([str(native.library_path()), native.available()]))
"""


def test_codec_follows_a_repointed_build_dir(tmp_path):
    """The host codec reads the build directory when it builds, so a
    re-pointed cache reaches it (it used to copy the directory when
    imported)."""
    env = dict(os.environ, PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", _CODEC, str(tmp_path)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    path, available = json.loads(out.stdout.strip().splitlines()[-1])
    assert os.path.dirname(path) == str(tmp_path)
    if shutil.which("c++"):
        assert available and os.listdir(tmp_path) == [
            os.path.basename(path)]


# --- the restart cycle -------------------------------------------------------

_PROBE = r"""
import json, os, sys, time
cache, ck = sys.argv[1], sys.argv[2]
import numpy as np
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.ops import cuda_build, native
from clonos_tpu_torch.runtime.cluster import ClusterRunner
from clonos_tpu_torch.utils.compile_cache import aot_lower_first_step
env = StreamEnvironment(name="persist", num_key_groups=8)
(env.synthetic_source(vocab=7, batch_size=4, parallelism=1)
    .key_by().window_count(num_keys=7, window_size=1 << 30).sink())
r = ClusterRunner(env.build(), steps_per_epoch=4, log_capacity=256,
                  max_epochs=8, inflight_ring_steps=16, seed=5,
                  checkpoint_dir=ck, compile_cache_dir=cache, device="cpu")
r.run_epoch(complete_checkpoint=True)
crc = native.crc32(np.arange(64, dtype=np.int32))
warm = aot_lower_first_step(r.executor)
print(json.dumps({"ok": warm is not None, "crc": crc,
                  "native": native.available(),
                  "entries": sorted(os.listdir(cache)),
                  "info": cuda_build.BUILD_INFO}))
"""


def _run_probe(cache_dir, ck_dir):
    env = dict(os.environ, PYTHONPATH=_REPO)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(cache_dir), str(ck_dir)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_fresh_interpreters_share_the_build_cache(tmp_path):
    """``test_fresh_process_hits_persistent_cache``'s restart cycle on
    the port: two fresh interpreters build runners on one cache
    directory, run an epoch and warm the first step; the second adds no
    entry, and the codec library the first built on its first use is
    loaded, not rebuilt, by the second."""
    shared = tmp_path / "cache"
    p1 = _run_probe(shared, tmp_path / "ck1")
    p2 = _run_probe(shared, tmp_path / "ck2")
    assert p1["ok"] and p2["ok"]
    assert p1["crc"] == p2["crc"]
    assert p2["entries"] == p1["entries"], \
        "the restarted process built again (new cache entries appeared)"
    assert not [e for e in p2["entries"] if ".tmp" in e]
    if shutil.which("c++"):
        assert p1["native"] and p2["native"]
        lib = p1["info"]["delta_codec.cpp"]
        assert os.path.basename(lib["path"]) in p1["entries"]
        assert lib["log"] != "(cached)"
        assert p2["info"]["delta_codec.cpp"] == dict(
            lib, seconds=0.0, log="(cached)")


# --- aot_lower_first_step ----------------------------------------------------

def test_aot_lower_first_step_moves_no_live_state():
    tr = obs.configure("runner")
    r = ClusterRunner(_headline_job(StreamEnvironment), device="cpu",
                      audit=True, **KW)
    r.run_epoch()
    for _ in range(3):
        r.step()
    before = _live(r)
    warm = aot_lower_first_step(r.executor, r._mgroup)
    assert warm is not None
    assert (warm.block_steps, warm.device) == (r.executor.block_steps, "cpu")
    _assert_live_equal(_live(r), before)
    names = [x["name"] for x in tr.records()]
    assert "recovery.aot-lower" in names
    assert "recovery.aot-lower-failed" not in names
    assert r._mgroup.counter("recovery.aot-lower-failed").value == 0


def test_aot_lower_failure_is_loud_in_both_packages(monkeypatch):
    """A first step that cannot be warmed returns None, emits the
    ``recovery.aot-lower-failed`` instant with the error and bumps the
    counter of that name — the reference's names on the same failure."""
    from clonos_tpu.obs import trace as jobs
    from clonos_tpu.utils.compile_cache import aot_lower_first_step as jaot
    tr = obs.configure("runner")
    r = ClusterRunner(_wc_job(StreamEnvironment), device="cpu", **KW)

    def boom(*_a, **_k):
        raise RuntimeError("no first step")
    monkeypatch.setattr(r.executor.compiled, "run_block", boom)
    assert aot_lower_first_step(r.executor, r._mgroup) is None
    got = [x for x in tr.records() if x["name"].startswith("recovery.aot")]
    assert [x["name"] for x in got] == ["recovery.aot-lower-failed"]
    assert "no first step" in got[0]["args"]["error"]
    assert r._mgroup.counter("recovery.aot-lower-failed").value == 1

    jtr = jobs.configure("runner")
    jr = _ref_wc()

    class _NoLower:
        def lower(self, *_a, **_k):
            raise RuntimeError("no first step")
    monkeypatch.setattr(jr.executor, "_jit_block", _NoLower())
    assert jaot(jr.executor, jr._mgroup) is None
    jgot = [x for x in jtr.records() if x["name"].startswith("recovery.aot")]
    assert [x["name"] for x in jgot] == [x["name"] for x in got]
    assert jr._mgroup.counter("recovery.aot-lower-failed").value == 1


# --- first_step_inputs -------------------------------------------------------

def test_first_step_inputs_match_the_reference():
    port = ClusterRunner(_headline_job(StreamEnvironment), device="cpu",
                         **KW).executor.first_step_inputs()
    from clonos_tpu.api.environment import StreamEnvironment as JEnv
    from clonos_tpu.runtime.cluster import ClusterRunner as JRunner
    ref = JRunner(_headline_job(JEnv), heartbeat_timeout_s=600.0,
                  **KW).executor.first_step_inputs()
    for f in ("times", "rng_bits", "epoch", "step0"):
        a, b = getattr(port, f), np.asarray(getattr(ref, f))
        assert tuple(a.shape) == b.shape, f
        assert str(a.dtype).split(".")[-1] == str(b.dtype), f
        assert not a.any(), f
    assert port.feeds == ref.feeds == ()


def _feed_job(env_cls):
    """Config #4's shape at test scale: feed -> window -> reduce -> sink."""
    env = env_cls(name="c4-mini", num_key_groups=16, default_edge_capacity=32)
    (env.host_source(batch_size=4, parallelism=2)
        .key_by().window_count(num_keys=9, window_size=40, parallelism=2)
        .key_by().reduce(num_keys=9, parallelism=2)
        .sink(parallelism=2))
    return env.build()


def _feed_parts():
    return [[(k % 9, k) for k in range(s, 400, 2)] for s in range(2)]


def test_first_step_inputs_of_a_feed_job_take_the_pull_shapes():
    from clonos_tpu_torch.api import feeds as tf
    ex = ClusterRunner(_feed_job(StreamEnvironment), device="cpu",
                       steps_per_epoch=3, seed=5,
                       inflight_ring_steps=16).executor
    ex.register_feed(0, tf.ListFeedReader(_feed_parts(), records_per_pull=3))
    got = ex.first_step_inputs()
    pulled = ex._pull_feeds(ex.block_steps)
    assert len(got.feeds) == len(pulled) == 1
    for a, b in zip(got.feeds[0], pulled[0]):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert not a.any()


# --- prewarm_recovery --------------------------------------------------------

def test_prewarmed_recovery_bit_identical_and_reusable():
    """``tests/test_recovery.py``'s warm standby on the port: recovery
    after ``prewarm_recovery()`` equals the port's golden run and the
    reference's prewarmed runner, twice over, and both continue alike."""
    golden = _port_wc()
    golden.run_epoch()
    golden.step()
    golden.step()
    r, jr = _port_wc(), _ref_wc()
    assert r.prewarm_recovery() >= 0
    assert jr.prewarm_recovery() >= 0
    for x in (r, jr):
        x.run_epoch()
        x.step()
        x.step()
        x.inject_failure([3])
        x.recover()
    _eq(_canon(r), _canon(golden), "port vs golden")
    _eq(_canon(r), _canon(jr), "port vs reference")
    for x in (r, jr):
        x.inject_failure([3])
    rep2 = r.recover()
    jr.recover()
    assert rep2.failed_subtasks == (3,)
    _eq(_canon(r), _canon(golden), "second recovery vs golden")
    _eq(_canon(r), _canon(jr), "second recovery vs reference")
    for x in (golden, r, jr):
        x.step()
    _eq(_canon(r), _canon(golden), "next step vs golden")
    _eq(_canon(r), _canon(jr), "next step vs reference")


def test_prewarm_requires_standby():
    r = ClusterRunner(_wc_job(StreamEnvironment), steps_per_epoch=3,
                      num_standby=0, seed=3, device="cpu")
    with pytest.raises(rec.RecoveryError, match="num_standby"):
        r.prewarm_recovery()
    with pytest.raises(rec.RecoveryError, match="num_standby"):
        ClusterRunner(_wc_job(StreamEnvironment), steps_per_epoch=3,
                      num_standby=0, seed=3, device="cpu", prewarm=True)


def test_from_config_full_restart_strategy_disables_standby():
    from clonos_tpu_torch.config import defaults as D
    from clonos_tpu_torch.config.options import Configuration
    cfg = Configuration().set(D.FAILOVER_STRATEGY, "full")
    r = ClusterRunner.from_config(_wc_job(StreamEnvironment), cfg,
                                  device="cpu")
    assert r.standbys.num_standby_per_vertex == 0
    with pytest.raises(rec.RecoveryError):
        r.prewarm_recovery()


def test_prewarm_in_the_constructor():
    """``prewarm=True`` warms at the end of construction: the fresh
    carry is untouched and the runs that follow equal an unwarmed
    runner's, through a recovery."""
    tr = obs.configure("runner")
    warm = ClusterRunner(_headline_job(StreamEnvironment), device="cpu",
                         prewarm=True, **KW)
    cold = ClusterRunner(_headline_job(StreamEnvironment), device="cpu",
                         **KW)
    assert "recovery.aot-lower" in [x["name"] for x in tr.records()]
    _eq(tree_leaves(carry_to_numpy(warm.executor.carry)),
        tree_leaves(carry_to_numpy(cold.executor.carry)), "fresh carry")
    for x in (warm, cold):
        x.run_epoch()
        x.step()
        x.inject_failure([4 + 1, 8 + 2])
        x.recover()
        x.run_epoch()
    _eq(_canon(warm), _canon(cold), "after a recovery")


def _coordinator_state(r):
    c = r.coordinator
    return (dict(c._pending), set(c._ignored), list(c._completed_ids),
            c._interval_steps, c.read_ledger(),
            {v: (sorted(t._pending), len(t.committed), t.committed_through)
             for v, t in r.txn_logs.items()})


def _txn_job(env_cls):
    """The headline's topology at a small width into a transactional
    sink."""
    env = env_cls(name="hl-txn", num_key_groups=16, default_edge_capacity=64)
    (env.synthetic_source(vocab=37, batch_size=8, parallelism=4)
        .key_by().window_count(num_keys=37, window_size=4)
        .key_by().reduce(num_keys=37).sink(transactional=True))
    return env.build()


@pytest.mark.parametrize("job,spill_paths", [
    (_headline_job, False), (_headline_job, True), (_txn_job, False)],
    ids=["headline", "headline-spill-paths", "transactional-sink"])
def test_prewarm_moves_no_live_state_and_no_ledger(job, spill_paths,
                                                   tmp_path):
    """Between epochs, mid-epoch and with a pending checkpoint, a warm
    leaves the carry, the counters, the RNG, the coordinator and the
    sinks' transactions as they were, and after three epochs the sealed
    ledger and the committed sink stream equal an unwarmed runner's."""
    from clonos_tpu_torch.obs.digest import diff_ledgers
    runs = {}
    for warmed in (True, False):
        r = ClusterRunner(job(StreamEnvironment), device="cpu",
                          audit=True,
                          checkpoint_dir=str(tmp_path / f"w{warmed}"), **KW)
        for complete in (True, False, True):
            r.run_epoch(complete_checkpoint=complete)
            r.step()
            if warmed:
                before = _live(r)
                ck = _coordinator_state(r)
                r.prewarm_recovery(spill_paths=spill_paths)
                _assert_live_equal(_live(r), before)
                assert _coordinator_state(r) == ck
        r.run_epoch()
        runs[warmed] = r
    assert diff_ledgers(runs[True].coordinator.read_ledger(),
                        runs[False].coordinator.read_ledger()) == []
    assert len(runs[True].coordinator.read_ledger()) == 4
    _eq(_canon(runs[True]), _canon(runs[False]), "warmed vs unwarmed")
    assert len(runs[True].txn_logs) == (job is _txn_job)
    for vid, tl in runs[True].txn_logs.items():
        other = runs[False].txn_logs[vid]
        assert tl.committed and len(tl.committed) == len(other.committed)
        for (e1, a1), (e2, a2) in zip(tl.committed, other.committed):
            assert e1 == e2
            np.testing.assert_array_equal(a1, a2)


def _join_job(env_cls):
    env = env_cls(name="nexmark-ish", num_key_groups=16,
                  default_edge_capacity=32)
    auctions = env.synthetic_source(vocab=7, batch_size=4, parallelism=2,
                                    name="auctions")
    bids = env.synthetic_source(vocab=7, batch_size=4, parallelism=2,
                                name="bids")
    auctions.key_by().join(bids.key_by(), num_keys=7, window=8,
                           interval=1 << 30, name="join").sink()
    return env.build()


@pytest.mark.parametrize("job,kill", [(_feed_job, [0, 3, 5]),
                                      (_join_job, [4, 5])],
                         ids=["feed-cascade", "join"])
def test_prewarmed_feed_and_join_recover_like_golden(job, kill):
    """The warm's feed-source and two-input branches: a prewarmed runner
    recovers a feed cascade and both join subtasks equal to golden."""
    from clonos_tpu_torch.api import feeds as tf

    def drive(warm):
        r = ClusterRunner(job(StreamEnvironment), device="cpu",
                          steps_per_epoch=3, seed=5, inflight_ring_steps=16)
        r.executor.time_source.now = lambda it=iter(range(0, 800, 10)): \
            next(it)
        if job is _feed_job:
            r.executor.register_feed(0, tf.ListFeedReader(
                _feed_parts(), records_per_pull=3))
        r.run_epoch()
        if warm:
            r.prewarm_recovery(spill_paths=True)
        r.step()
        r.step()
        return r
    golden, r = drive(False), drive(True)
    r.inject_failure(kill)
    assert r.recover().steps_replayed == 2
    _eq(_canon(r), _canon(golden), "recovered vs golden")
    for x in (golden, r):
        x.run_epoch()
    _eq(_canon(r), _canon(golden), "next epoch vs golden")


# --- on two gloo ranks -------------------------------------------------------

def _mesh_schedule(r, kill):
    r.run_epoch(complete_checkpoint=True)
    r.run_epoch(complete_checkpoint=False)
    r.inject_failure([kill])
    rep = r.recover()
    r.run_epoch(complete_checkpoint=True)
    return rep


def rank_prewarm(ctx, root, kill):
    """A sharded runner prewarmed after its first epoch, the first step
    warmed, then ``_mesh_schedule``'s shard-local recovery."""
    mesh = dist_.task_mesh()
    r = ClusterRunner(_headline_job(StreamEnvironment, 8), device="cpu",
                      mesh=mesh, checkpoint_dir=os.path.join(root, "mesh"),
                      compile_cache_dir=os.path.join(root, "cc"), **KW)
    r.run_epoch(complete_checkpoint=True)
    before = [x.clone() for x in tree_leaves(r.executor.carry)]
    seconds = r.prewarm_recovery()
    warm = aot_lower_first_step(r.executor, r._mgroup)
    same = all(torch.equal(a, b)
               for a, b in zip(before, tree_leaves(r.executor.carry)))
    r.run_epoch(complete_checkpoint=False)
    r.inject_failure([kill])
    rep = r.recover()
    r.run_epoch(complete_checkpoint=True)
    return {"seconds": seconds, "warm": warm is not None, "same": same,
            "cache": r._compile_cache_dir, "managers": len(rep.managers),
            "full": [x.numpy() for x in tree_leaves(
                r.executor.full_carry())],
            "ledger": (r.coordinator.read_ledger() if ctx.process_id == 0
                       else None)}


def test_prewarm_then_shard_local_recovery_on_two_gloo_ranks(tmp_path):
    """``tests/test_multichip.py``'s AOT check on the port: both ranks
    prewarm and warm the first step in lockstep, their live shards stay
    put, the cache directory is the mesh and placement namespace, and a
    window subtask recovered on its rank equals the unsharded control."""
    from clonos_tpu_torch.obs.digest import diff_ledgers
    kill = 8 + 6                 # window subtask 6: rank 1's block (4-7)
    res = dist_.spawn(f"{_HERE}:rank_prewarm", 2,
                      {"root": str(tmp_path), "kill": kill}, device="cpu",
                      timeout_s=RANK_TIMEOUT_S)
    control = ClusterRunner(_headline_job(StreamEnvironment, 8),
                            device="cpu",
                            checkpoint_dir=str(tmp_path / "control"), **KW)
    control.run_epoch(complete_checkpoint=True)
    control.run_epoch(complete_checkpoint=False)
    control.inject_failure([kill])
    control.recover()
    control.run_epoch(complete_checkpoint=True)
    assert [x["warm"] for x in res] == [True, True]
    assert [x["same"] for x in res] == [True, True]
    assert [x["managers"] for x in res] == [0, 1]
    assert res[0]["cache"] == res[1]["cache"]
    key = os.path.basename(res[0]["cache"])
    assert key.split("-")[0] != "nomesh" and not key.endswith("nospec")
    assert os.path.dirname(res[0]["cache"]) == str(tmp_path / "cc")
    for x, y in zip(res[0]["full"], tree_leaves(control.executor.carry)):
        np.testing.assert_array_equal(x, y.numpy())
    for x, y in zip(res[0]["full"], res[1]["full"]):
        np.testing.assert_array_equal(x, y)
    assert diff_ledgers(control.coordinator.read_ledger(),
                        res[0]["ledger"]) == []


# --- bootstrap ---------------------------------------------------------------

def _mirror_rows(rows, heads, tails):
    cap = rows.shape[1]
    return {f: (rows[f][np.arange(int(tails[f]), int(heads[f])) & (cap - 1)],
                int(tails[f]))
            for f in range(rows.shape[0])}


def test_bootstrap_with_a_cache_dir_equals_the_reference(tmp_path):
    """``bootstrap_standby(..., compile_cache_dir=...)`` rebuilds what the
    reference's bootstrap rebuilds, warms the first step on its worker
    (a ``recovery.aot-lower`` span, no failure) and keeps
    ``finalize.first-step-recompile`` in its phases."""
    from clonos_tpu.api.environment import StreamEnvironment as JEnv
    from clonos_tpu.runtime.cluster import ClusterRunner as JRunner
    kw = dict(KW, steps_per_epoch=4)
    ref = JRunner(_headline_job(JEnv), heartbeat_timeout_s=600.0,
                  checkpoint_dir=str(tmp_path / "ref"), **kw)
    dead = ClusterRunner(_headline_job(StreamEnvironment),
                         checkpoint_dir=str(tmp_path / "port"),
                         device="cpu", **kw)
    for r in (ref, dead):
        for _ in range(3):
            r.run_epoch(complete_checkpoint=True)
        r.run_epoch(complete_checkpoint=False)
    logs = ref.executor.carry.logs
    mirror = _mirror_rows(np.asarray(logs.rows), np.asarray(logs.head),
                          np.asarray(logs.tail))
    jb, jrep = JRunner.bootstrap_standby(
        _headline_job(JEnv), str(tmp_path / "ref"), mirror,
        heartbeat_timeout_s=600.0, **kw)
    tr = obs.configure("standby")
    tb, trep = ClusterRunner.bootstrap_standby(
        _headline_job(StreamEnvironment), str(tmp_path / "port"), mirror,
        device="cpu", compile_cache_dir=str(tmp_path / "cc"), **kw)
    assert tb._compile_cache_dir == str(tmp_path / "cc")
    assert trep.steps_replayed == jrep.steps_replayed == 4
    _eq(_canon(tb), _canon(jb), "port vs reference rebuild")
    _eq(_canon(tb), _canon(dead), "rebuild vs dead runner")
    pm = trep.phase_ms
    assert {k for k in pm if k.startswith("finalize")} == \
        {k for k in jrep.phase_ms if k.startswith("finalize")}
    assert pm["finalize.first-step-recompile"] >= 0
    names = [x["name"] for x in tr.records()]
    assert "recovery.aot-lower" in names
    assert "recovery.aot-lower-failed" not in names
    for r in (tb, jb, dead):
        r.run_epoch(complete_checkpoint=True)
    _eq(_canon(tb), _canon(jb), "next epoch vs reference")
    _eq(_canon(tb), _canon(dead), "next epoch vs dead")
