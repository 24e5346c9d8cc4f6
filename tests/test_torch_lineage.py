"""PyTorch port, record lineage (mirror of the reference's
``tests/test_lineage.py``).

The dye sampler, the disabled plane, the wire stamp and its adoption,
the tag codec, the observation reader and the reconstructor are driven
with the same inputs through the reference (``clonos_tpu.obs.lineage``)
and the port, and must agree. The window the seal scan reads comes from
the port's ``executor.iter_ring_steps`` over its own ``epoch_window``
(rings compacted on the device in step, lane, slot order): it must yield
the reference's tuples element for element. Then the live capture: a
seeded wordcount, a seeded headline-shaped job and a transactional-sink
job, each run at small width on both packages with the same seed and a
plane of the same name, write byte-equal observation files, and every
dyed key's reconstructed path is equal; the pipelined fence observes
what the sequential one does, with the audit off (the window captured
for lineage alone). ``lineage --report json`` renders the same bytes in
two fresh processes and in the reference's CLI, and the schema
fingerprint equals the pinned ``.clonos-lineage-schema``. Serve reads
of dyed keys land ``serve`` termini through the router's provenance
stamp. The reference's soak-driven test waits for the port's soak
harness (ROADMAP Queue 1 item 8). Tolerance: exact.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from clonos_tpu.api.environment import StreamEnvironment as JaxEnv
from clonos_tpu.obs import lineage as jlin
from clonos_tpu.parallel import transport as jtp
from clonos_tpu.runtime import executor as jexec
from clonos_tpu.runtime.cluster import ClusterRunner as JaxRunner
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.obs import lineage as tlin
from clonos_tpu_torch.parallel import transport as ttp
from clonos_tpu_torch.runtime import executor as texec
from clonos_tpu_torch.runtime.cluster import ClusterRunner
from clonos_tpu_torch.utils.metrics import MetricRegistry

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(steps_per_epoch=4, log_capacity=256, max_epochs=8,
          inflight_ring_steps=16, seed=3, logical_time=True)


@pytest.fixture(autouse=True)
def _reset_globals():
    yield
    tlin.reset_lineage()
    jlin.reset_lineage()


def _cli_lineage(module, *args):
    return subprocess.run(
        [sys.executable, "-m", module, "lineage", *args],
        capture_output=True, text=True, cwd=_REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=_REPO))


def test_lineage_schema_fingerprint_equals_pin():
    with open(os.path.join(_REPO, ".clonos-lineage-schema")) as f:
        pinned = f.read().split()[0]
    assert tlin.lineage_schema_fingerprint() == pinned == \
        jlin.lineage_schema_fingerprint()
    assert tlin.LINEAGE_SCHEMA == jlin.LINEAGE_SCHEMA
    assert tlin.OBSERVATION_KINDS == jlin.OBSERVATION_KINDS


# --- the dye sampler ---------------------------------------------------------


def test_select_dyed_pure_function_of_the_key_set():
    keys = [5, 3, 9, 3, 5, 12, 44, 7]
    a = tlin.select_dyed(keys, epoch=6, salt=17, k=3)
    assert a == jlin.select_dyed(keys, epoch=6, salt=17, k=3)
    b = tlin.select_dyed(list(reversed(sorted(set(keys)))), epoch=6,
                         salt=17, k=3)
    assert a == b and len(a) == 3 and set(a) <= set(keys)
    assert set(tlin.select_dyed(keys, epoch=6, salt=17, k=99)) == set(keys)
    assert tlin.select_dyed(keys, epoch=6, salt=17, k=0) == []
    rng = np.random.RandomState(5)
    for _ in range(20):
        ks = rng.randint(-1000, 1000, size=40).tolist()
        ep, salt, k = (int(rng.randint(64)), int(rng.randint(1 << 30)),
                       int(rng.randint(8)))
        assert tlin.select_dyed(ks, epoch=ep, salt=salt, k=k) == \
            jlin.select_dyed(ks, epoch=ep, salt=salt, k=k)


def test_dye_hash_is_stable():
    rng = np.random.RandomState(9)
    for key, ep, salt in rng.randint(-(1 << 31), 1 << 31, size=(50, 3)):
        assert tlin.dye_hash(key, ep, salt) == \
            jlin.dye_hash(int(key), int(ep), int(salt))
    assert tlin.dye_hash(7, 3, 17) != tlin.dye_hash(7, 4, 17)


# --- the disabled identity ---------------------------------------------------


def test_null_lineage_is_inert_and_default():
    g = tlin.get_lineage()
    assert isinstance(g, tlin.NullLineage)
    assert g.enabled is False and g.wire_config() is None
    assert g.observe_epoch(0, {"logs": {}, "rings": {}}) == 0
    assert g.observe_serve(5, epoch=0, replica="r") is False
    assert g.is_dyed(5) is False
    reg = MetricRegistry()
    g.register_gauges(reg)
    assert not any(k.startswith("lineage.") for k in reg.snapshot())
    g.sync()
    g.close()


def test_wire_stamp_only_when_enabled(tmp_path):
    hdr = ttp.attach_lineage({"verb": "DEPLOY"})
    assert "lineage" not in hdr
    tlin.configure_lineage(str(tmp_path), k=2, salt=99)
    jlin.configure_lineage(str(tmp_path), k=2, salt=99)
    hdr = ttp.attach_lineage({"verb": "DEPLOY"})
    assert hdr == jtp.attach_lineage({"verb": "DEPLOY"})
    assert hdr["lineage"]["k"] == 2 and hdr["lineage"]["salt"] == 99
    # A fresh receiver adopts the sender's dye config; one that already
    # has a plane keeps its own.
    tlin.reset_lineage()
    ttp.adopt_lineage(hdr)
    g = tlin.get_lineage()
    assert g.enabled and g.k == 2 and g.salt == 99
    ttp.adopt_lineage({"lineage": {"root": str(tmp_path), "k": 7,
                                   "salt": 1}})
    assert tlin.get_lineage() is g


def test_lineage_tag_codec_roundtrip():
    from clonos_tpu.causal import serde as jserde
    from clonos_tpu_torch.causal import serde
    tags = [(100, 2, 7, 1, 3), (5, 0, 0, 0, 0)]
    frame = serde.encode_lineage_tags(tags)
    assert frame == jserde.encode_lineage_tags(tags)
    assert serde.decode_lineage_tags(frame) == tags
    with pytest.raises(ValueError):
        serde.decode_lineage_tags(frame[:-1] + b"\x00")


# --- observation files -------------------------------------------------------


def _one_epoch_file(mod, root):
    p = mod.LineagePlane(str(root), service="t", k=2)
    n = p.observe_epoch(0, {"logs": {}, "rings": {
        0: [([3, 5], [1, 1], [0, 1])]}})
    p.close()
    return n, os.path.join(str(root), "lineage-t.jsonl")


def test_read_observations_tolerates_torn_tail(tmp_path):
    n, path = _one_epoch_file(tlin, tmp_path / "port")
    rn, rpath = _one_epoch_file(jlin, tmp_path / "ref")
    with open(path, "rb") as a, open(rpath, "rb") as b:
        assert a.read() == b.read()
    assert n == rn == len(tlin.read_observations(path)) > 0
    with open(path, "a") as f:
        f.write('{"kind": "hop", "torn')
    assert len(tlin.read_observations([path])) == n
    with open(path, "a") as f:
        f.write('\n{"kind": "dye", "key": 3}\n')
    with pytest.raises(ValueError):
        tlin.read_observations(path)


def test_observe_epoch_is_idempotent(tmp_path):
    p = tlin.LineagePlane(str(tmp_path), service="t", k=2)
    win = {"logs": {}, "rings": {0: [([3, 5], [1, 1], [0, 1])]}}
    n1 = p.observe_epoch(4, win)
    assert p.observe_epoch(4, win) == 0
    p.close()
    assert len(tlin.read_observations(str(tmp_path / "lineage-t.jsonl"))) \
        == n1


def test_self_check_clean():
    assert tlin.lineage_self_check() == [] == jlin.lineage_self_check()
    obs = tlin._synthetic_observations()
    assert tlin.render_trace(tlin.reconstruct(obs)) == \
        jlin.render_trace(jlin.reconstruct(obs))
    assert tlin.format_trace(tlin.reconstruct(obs)) == \
        jlin.format_trace(jlin.reconstruct(obs))


# --- the window the seal scan reads ------------------------------------------


def _window_job(env_cls):
    env = env_cls(name="linjob", num_key_groups=16)
    (env.synthetic_source(vocab=11, batch_size=8, parallelism=2)
        .key_by()
        .window_count(num_keys=11, window_size=1 << 30, name="w"))
    return env.build()


def test_iter_ring_steps_yields_the_reference_tuples(tmp_path):
    """The port's rings are compacted on the device (step, lane, slot
    order); ``iter_ring_steps`` over its ``epoch_window`` yields the
    reference's ``(vertex, step, keys, values, timestamps)`` element for
    element, and the function equals the reference's on one dict."""
    ref = JaxRunner(_window_job(JaxEnv), **KW)
    port = ClusterRunner(_window_job(StreamEnvironment), device="cpu", **KW)
    for r in (ref, port):
        r.run_epoch(complete_checkpoint=False)
        r.run_epoch(complete_checkpoint=False)
    for epoch in (0, 1):
        got = list(texec.iter_ring_steps(port.executor.epoch_window(epoch)))
        want = list(jexec.iter_ring_steps(ref.executor.epoch_window(epoch)))
        assert len(got) == len(want) == KW["steps_per_epoch"]
        for g, w in zip(got, want):
            assert g[:2] == w[:2]
            for a, b in zip(g[2:], w[2:]):
                assert np.array_equal(np.asarray(a), np.asarray(b))
    win = ref.executor.epoch_window(0)
    assert [t[:2] for t in texec.iter_ring_steps(win)] == \
        [t[:2] for t in jexec.iter_ring_steps(win)]


# --- live capture: both packages, one seed -----------------------------------


def _wordcount(env_cls):
    env = env_cls(name="socket-window-wordcount", num_key_groups=64)
    (env.synthetic_source(vocab=1000, batch_size=64, parallelism=4,
                          name="words")
        .key_by()
        .window_count(num_keys=1000, window_size=500, name="window")
        .sink(name="print"))
    return env.build()


def _headline(env_cls, transactional=False):
    env = env_cls(name="bench-allround", num_key_groups=8,
                  default_edge_capacity=16)
    (env.synthetic_source(vocab=13, batch_size=4, parallelism=3)
        .key_by()
        .window_count(num_keys=13, window_size=8, name="window")
        .key_by()
        .reduce(num_keys=13, name="reduce")
        .sink(transactional=transactional))
    return env.build()


_BUILDERS = {"wordcount": _wordcount, "headline": _headline,
             "txn": lambda env_cls: _headline(env_cls, transactional=True)}


def _observe(pkg, name, root, epochs=3, **runner_kw):
    lin, runner_cls, env_cls, kw = (
        (tlin, ClusterRunner, StreamEnvironment, {"device": "cpu"})
        if pkg == "port" else (jlin, JaxRunner, JaxEnv, {}))
    plane = lin.LineagePlane(str(root), service="run", k=3)
    r = runner_cls(_BUILDERS[name](env_cls), lineage=plane,
                   checkpoint_dir=str(root / "ck"), **kw, **KW,
                   **runner_kw)
    for _ in range(epochs):
        r.run_epoch(complete_checkpoint=True)
    r.drain_fence()
    plane.close()
    path = str(root / "lineage-run.jsonl")
    with open(path, "rb") as f:
        raw = f.read()
    return r, plane, path, raw


@pytest.mark.parametrize("name", ["wordcount", "headline", "txn"])
def test_observations_equal_reference(tmp_path, name):
    """The same seeded job on both packages dyes the same records: the
    observation files are byte-equal and every dyed key's reconstructed
    path is equal, its hops carrying key group and subtask. Without a
    transactional sink no path has a terminus, so none is broken; with
    one, the dyed keys that reached a sink part have whole paths, and a
    key whose window did not fire within the run is the one break
    (``no-terminus``), on both packages alike."""
    _, _, rpath, rraw = _observe("ref", name, tmp_path / "ref")
    r, plane, path, raw = _observe("port", name, tmp_path / "port")
    assert raw == rraw
    rep = tlin.reconstruct(tlin.read_observations(path))
    assert tlin.render_trace(rep) == jlin.render_trace(
        jlin.reconstruct(jlin.read_observations(rpath)))
    assert len(rep["keys"]) >= 3
    for p in rep["keys"].values():
        assert p["dyed_at"] is not None and p["hops"]
        assert all("subtask" in h and "key_group" in h for h in p["hops"])
        assert p["broken"] == ([] if p["sinks"] else
                               ["no-terminus"] if name == "txn" else [])
    if name == "txn":
        assert any(p["sinks"] for p in rep["keys"].values())
    else:
        assert rep["ok"] is True
    snap = r.metrics.snapshot()
    assert snap["lineage.dyed"] == plane.dyed > 0
    assert snap["lineage.epochs-observed"] == 3
    assert snap["lineage.k"] == 3


def test_pipelined_fence_observes_what_the_sequential_one_does(tmp_path):
    """Audit off and the pipelined fence on: the window is captured for
    the lineage scan alone, and the observations equal the sequential
    fence's."""
    _, _, _, seq = _observe("port", "txn", tmp_path / "seq", audit=False)
    _, _, _, ovl = _observe("port", "txn", tmp_path / "ovl", audit=False,
                            overlap_epoch=True)
    assert ovl == seq and seq


def test_trace_byte_identical_across_two_processes(tmp_path):
    _, _, path, _ = _observe("port", "headline", tmp_path, epochs=2)
    a = _cli_lineage("clonos_tpu_torch", path, "--report", "json")
    b = _cli_lineage("clonos_tpu_torch", path, "--report", "json")
    ref = _cli_lineage("clonos_tpu.cli", path, "--report", "json")
    assert a.returncode == b.returncode == ref.returncode == 0, a.stderr
    assert a.stdout and a.stdout == b.stdout == ref.stdout
    rep = json.loads(a.stdout)
    assert rep["ok"] is True
    assert rep["schema_fingerprint"] == tlin.lineage_schema_fingerprint()
    key = sorted(rep["keys"], key=int)[0]
    k1 = _cli_lineage("clonos_tpu_torch", path, "--key", key, "--report",
                      "json")
    k2 = _cli_lineage("clonos_tpu.cli", path, "--key", key, "--report",
                      "json")
    assert k1.returncode == 0 and k1.stdout == k2.stdout
    t1 = _cli_lineage("clonos_tpu_torch", path, "--key", key)
    t2 = _cli_lineage("clonos_tpu.cli", path, "--key", key)
    assert t1.returncode == 0 and t1.stdout == t2.stdout


def test_cli_self_check_and_chrome_export(tmp_path):
    out = _cli_lineage("clonos_tpu_torch", "--self-check")
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout)
    assert line["ok"] is True and line["findings"] == []
    _, _, path, _ = _observe("port", "headline", tmp_path, epochs=1)
    docs = []
    for module, name in (("clonos_tpu_torch", "port"),
                         ("clonos_tpu.cli", "ref")):
        dst = str(tmp_path / f"chrome-{name}.json")
        out = _cli_lineage(module, path, "--chrome", dst)
        assert out.returncode == 0, out.stderr
        with open(dst) as f:
            docs.append(json.load(f))
    assert docs[0] == docs[1] and docs[0]["traceEvents"]


# --- serve-read terminus + provenance stamp ----------------------------------


def test_serve_reads_carry_provenance_and_feed_lineage(tmp_path):
    from clonos_tpu_torch.runtime.serve import build_serve_tier

    plane = tlin.LineagePlane(str(tmp_path), service="serve", k=4)
    env = StreamEnvironment(name="serve", num_key_groups=16,
                            default_edge_capacity=64)
    (env.synthetic_source(vocab=11, batch_size=8, parallelism=2)
        .key_by().reduce(num_keys=11, name="r").sink())
    r = ClusterRunner(env.build(), steps_per_epoch=4, log_capacity=256,
                      max_epochs=8, inflight_ring_steps=16, seed=3,
                      lineage=plane, device="cpu")
    tier = build_serve_tier(r, 1, n_replicas=1)
    try:
        r.run_epoch(complete_checkpoint=True)
        r.drain_fence()
        dyed = sorted(plane._dyed_recent)
        assert dyed, "an epoch must have dyed records"
        out = tier.router.query(1, dyed[0])
        assert out["replica"] == "replica-0"
        assert out["rerouted"] is False and out["epoch"] >= 0
        assert tier.clients[0].query(1, dyed[0])["replica"] == "replica-0"
        batch = tier.router.query_batch(1, [0, 1, 2])
        assert batch["rerouted"] == [False, False, False]
        before = plane.serve_hits
        assert before >= 1, "dyed reads must land serve observations"
        tier.router.query(1, dyed[0])
        assert plane.serve_hits == before + 1
    finally:
        tier.close()
        plane.close()
    obs = tlin.read_observations(str(tmp_path / "lineage-serve.jsonl"))
    serves = [o for o in obs if o["kind"] == "serve"]
    assert serves and any(o["key"] == dyed[0] for o in serves)
    path = tlin.reconstruct(obs)["keys"][str(dyed[0])]
    assert path["serves"] and path["broken"] == []
