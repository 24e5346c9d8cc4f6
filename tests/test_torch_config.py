"""PyTorch port, typed configuration: mirrors of the reference's
``tests/test_config.py`` (all five cases) and of the ``from_config``
cases of ``tests/test_control_determinants.py``, plus parity with the
reference: every option of ``config/defaults.py`` (key, default, type,
validator verdicts) and the runners ``ClusterRunner.from_config`` builds
in both packages from the same configurations. Tolerance: exact."""

import pytest

from clonos_tpu.api.environment import StreamEnvironment as JaxEnv
from clonos_tpu.config import defaults as jdefaults
from clonos_tpu.config.options import Configuration as JaxConfiguration
from clonos_tpu.obs import profile as jprof
from clonos_tpu.runtime.cluster import ClusterRunner as JaxRunner
from clonos_tpu_torch import obs
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.config import ConfigOption, Configuration, defaults
from clonos_tpu_torch.config import options as opt_mod
from clonos_tpu_torch.runtime.cluster import ClusterRunner


@pytest.fixture(autouse=True)
def _null_obs_after():
    yield
    obs.reset()
    obs.reset_profile()
    jprof.reset_profile()


def test_defaults_and_typed_get():
    c = Configuration()
    assert c.get(defaults.DETERMINANT_SHARING_DEPTH) == -1
    assert c.get(defaults.INFLIGHT_TYPE) == "inmemory"
    c.set(defaults.DETERMINANT_SHARING_DEPTH, 2)
    assert c.get(defaults.DETERMINANT_SHARING_DEPTH) == 2


def test_type_enforcement():
    c = Configuration()
    with pytest.raises(TypeError):
        c.set(defaults.NUM_STANDBY_TASKS, "two")
    with pytest.raises(TypeError):
        c.set(defaults.NUM_STANDBY_TASKS, True)  # bool is not int here


def test_validator():
    c = Configuration()
    with pytest.raises(ValueError):
        c.set(defaults.INFLIGHT_TYPE, "bogus")
    with pytest.raises(ValueError):
        c.set(defaults.DETERMINANT_LOG_CAPACITY, 1000)  # not a power of 2
    c.set(defaults.DETERMINANT_LOG_CAPACITY, 1024)


def test_int_to_float_coercion():
    c = Configuration()
    c.set(defaults.CHECKPOINT_BACKOFF_MULTIPLIER, 3)
    assert c.get(defaults.CHECKPOINT_BACKOFF_MULTIPLIER) == 3.0


def test_merge_and_raw():
    a = Configuration({"x": 1})
    b = Configuration({"x": 2, "y": 3})
    m = a.merged_with(b)
    assert m.to_dict() == {"x": 2, "y": 3}
    opt = ConfigOption("x", 0)
    assert m.get(opt) == 2


def _options(mod):
    return {name: o for name, o in vars(mod).items()
            if isinstance(o, (opt_mod.ConfigOption,
                              __import__("clonos_tpu.config.options",
                                         fromlist=["ConfigOption"])
                              .ConfigOption))}


#: values probed through every option's validator and type check
_PROBES = (-1, 0, 1, 3, 1000, 1024, 0.5, 2.0, True, "", "flat", "grouped",
           "spillable", "inmemory", "disabled", "eager", "availability",
           "epoch", "warn", "abort", "standbytask", "full", None)


def _verdict(option, value):
    try:
        return ("ok", option.check(value))
    except (TypeError, ValueError) as e:
        return (type(e).__name__,)


def test_every_option_matches_reference():
    """Every option of ``config/defaults.py``: the same attribute name,
    key, default and type as the reference's, and the same verdict from
    its type check and validator on every probe value."""
    mine, ref = _options(defaults), _options(jdefaults)
    assert set(mine) == set(ref) and len(mine) >= 30
    for name, o in mine.items():
        r = ref[name]
        assert (o.key, o.default, o.type) == (r.key, r.default, r.type), name
        for v in _PROBES:
            assert _verdict(o, v) == _verdict(r, v), (name, v)


def _job(env_cls, name="cfg"):
    env = env_cls(name=name, num_key_groups=8)
    (env.synthetic_source(vocab=5, batch_size=4, parallelism=2)
        .key_by().window_count(num_keys=5, window_size=1 << 30).sink())
    return env.build()


def _settings(r):
    ex = r.executor
    spill = ex.spill_logs is not None
    return dict(
        steps_per_epoch=ex.steps_per_epoch,
        log_capacity=ex.compiled.log_capacity,
        max_epochs=ex.compiled.max_epochs,
        ring_steps=ex.compiled.inflight_ring_steps,
        spill_policy=str(getattr(ex.spill_policy, "value", ex.spill_policy))
        if spill else None,
        spill_paths=sorted(sl.store.spool_dir for sl in ex.spill_logs)
        if spill else None,
        audit=(r.auditor.enabled, r.auditor.on_divergence
               if r.auditor.enabled else None),
        standby=r.standbys.num_standby_per_vertex,
        heartbeat_timeout_s=r.heartbeats.timeout_s,
        backoff=r.coordinator.backoff_multiplier,
        sharing_depth=r.job.sharing_depth,
        profiler=r.profiler.enabled)


def _configs(root):
    yield {}
    yield {"checkpoint.interval-steps": 4, "causal.log.capacity": 512,
           "causal.log.max-epochs": 8,
           "taskmanager.inflight.capacity-batches": 16,
           "jobmanager.execution.num-standby-tasks": 2,
           "causal.determinant-sharing-depth": 2, "heartbeat.timeout": 250}
    yield {"jobmanager.execution.failover-strategy": "full",
           "observability.audit.enabled": True,
           "observability.audit.on-divergence": "abort",
           "jobmanager.execution.checkpoint-backoff-multiplier": 3,
           "causal.log.capacity": 512}
    yield {"taskmanager.inflight.type": "spillable",
           "taskmanager.inflight.spill.policy": "availability",
           "taskmanager.inflight.spill.host-budget-epochs": 1,
           "checkpoint.dir": root, "checkpoint.interval-steps": 4,
           "causal.log.capacity": 512,
           "observability.profile.enabled": True}


def test_from_config_runners_match_reference(tmp_path):
    """The same configurations through both packages' ``from_config``:
    equal epoch length, log and ring sizes, spill policy and spool
    directory, audit, standby count, heartbeat timeout, backoff and
    sharing depth."""
    for i, values in enumerate(_configs(str(tmp_path / "ck"))):
        port = ClusterRunner.from_config(
            _job(StreamEnvironment), Configuration(dict(values)),
            device="cpu", logical_time=True)
        ref = JaxRunner.from_config(_job(JaxEnv),
                                    JaxConfiguration(dict(values)),
                                    logical_time=True)
        mine = _settings(port)
        spill_root = mine.pop("spill_paths")
        want = _settings(ref)
        ref_root = want.pop("spill_paths")
        assert mine == want, values
        if spill_root is not None:
            assert spill_root == ref_root
        if port.executor.spill_logs is not None:
            port.executor.close_spill()
        obs.reset_profile()
        jprof.reset_profile()


def test_from_config_builds_runner():
    cfg = (Configuration()
           .set(defaults.CHECKPOINT_INTERVAL_STEPS, 4)
           .set(defaults.DETERMINANT_LOG_CAPACITY, 512)
           .set(defaults.DETERMINANT_MAX_EPOCHS, 8)
           .set(defaults.INFLIGHT_CAPACITY_BATCHES, 16)
           .set(defaults.NUM_STANDBY_TASKS, 2)
           .set(defaults.DETERMINANT_SHARING_DEPTH, 2)
           .set(defaults.HEARTBEAT_TIMEOUT_MS, 250))
    job = _job(StreamEnvironment)
    r = ClusterRunner.from_config(job, cfg, device="cpu", logical_time=True)
    assert r.executor.steps_per_epoch == 4
    assert r.executor.compiled.log_capacity == 512
    assert r.executor.compiled.max_epochs == 8
    assert r.executor.compiled.inflight_ring_steps == 16
    assert r.standbys.num_standby_per_vertex == 2
    assert r.heartbeats.timeout_s == 0.25
    assert job.sharing_depth == 2
    r.run_epoch()                            # functional end to end


def test_from_config_full_restart_strategy_disables_standby():
    cfg = Configuration().set(defaults.FAILOVER_STRATEGY, "full")
    r = ClusterRunner.from_config(_job(StreamEnvironment), cfg,
                                  device="cpu")
    assert r.standbys.num_standby_per_vertex == 0


def test_from_config_defaults_to_the_card():
    """``from_config`` passes ``device`` through and defaults to the
    card: without one it raises instead of running on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        ClusterRunner.from_config(_job(StreamEnvironment))


def test_tracing_options_install_the_process_tracer(tmp_path):
    """``observability.tracing.*`` install the process tracer, writing
    ``trace-runner.jsonl`` under the tracing dir with the configured
    ring size; an already installed tracer is kept."""
    cfg = (Configuration()
           .set(defaults.TRACING_ENABLED, True)
           .set(defaults.TRACE_DIR, str(tmp_path / "traces"))
           .set(defaults.TRACE_BUFFER_EVENTS, 4)
           .set(defaults.CHECKPOINT_INTERVAL_STEPS, 2))
    r = ClusterRunner.from_config(_job(StreamEnvironment), cfg,
                                  device="cpu", logical_time=True)
    tr = obs.get_tracer()
    assert tr.enabled and tr.service == "runner"
    r.run_epoch()
    assert len(tr.records()) == 4 and tr.dropped > 0
    path = tmp_path / "traces" / "trace-runner.jsonl"
    assert len(obs.load_jsonl(str(path))) == 4 + tr.dropped
    ClusterRunner.from_config(_job(StreamEnvironment), cfg, device="cpu")
    assert obs.get_tracer() is tr
