"""PyTorch port on the card: the hand-written Hopper keyed-histogram kernel
against its plain version, a small job's card run against its CPU run,
and fed blocks staged in pinned memory against the old host packing.
Tolerance: exact equality (int32/bool).

Every test here needs a CUDA card (marker ``cuda``) and skips without one.
The file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.ops import histogram as th
from clonos_tpu_torch.runtime.executor import LocalExecutor, canonical_carry
from clonos_tpu_torch.utils.tree import tree_leaves

# `cuda` is registered in pytest.ini. The marker lint's registry
# (clonos_tpu/lint/markers.py) belongs to the reference package and lists
# only its own markers, so the name is looked up rather than spelled as an
# attribute, which that lint would flag.
pytestmark = getattr(pytest.mark, "cuda")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed, lead, b, nk):
    rng = np.random.RandomState(seed)
    shape = lead + (b,)
    keys = rng.randint(-3, nk + 4, shape).astype(np.int32)
    vals = rng.randint(-50, 50, shape).astype(np.int32)
    valid = rng.rand(*shape) < 0.7
    return keys, vals, valid


@pytest.mark.parametrize("nk", [13, 8192, 70000])
def test_cuda_kernel_matches_plain_on_card(cuda_device, nk):
    keys, vals, valid = _inputs(nk, (3, 5), 300, nk)
    args = [torch.from_numpy(a).to(cuda_device) for a in (keys, vals, valid)]
    for want_counts in (True, False):
        before = th.keyed_hist.launches
        s, c = th.keyed_hist(*args, nk, want_counts=want_counts)
        torch.cuda.synchronize()
        assert th.keyed_hist.launches == before + 1
        s2, c2 = th.keyed_hist_plain(*(a.reshape(15, 300) for a in args),
                                     nk, want_counts)
        assert torch.equal(s.reshape(15, nk), s2)
        if want_counts:
            assert torch.equal(c.reshape(15, nk), c2)
        else:
            assert c is None and c2 is None


def test_card_run_equals_cpu_run(cuda_device):
    def job():
        env = StreamEnvironment(name="card-vs-cpu", num_key_groups=64,
                                default_edge_capacity=128)
        (env.synthetic_source(vocab=211, batch_size=32, parallelism=2)
            .key_by()
            .window_count(num_keys=211, window_size=16, name="window")
            .key_by()
            .reduce(num_keys=211, name="reduce")
            .sink())
        return env.build()

    kw = dict(steps_per_epoch=32, log_capacity=1 << 9, max_epochs=8,
              inflight_ring_steps=32, block_steps=16, logical_time=True,
              seed=5)
    card = LocalExecutor(job(), device=cuda_device, **kw)
    cpu = LocalExecutor(job(), device="cpu", **kw)
    before = th.keyed_hist.launches
    for _ in range(2):
        oa, ob = card.run_epoch(), cpu.run_epoch()
        for vid in ob.sinks:
            for a, b in zip(oa.sinks[vid], ob.sinks[vid]):
                assert torch.equal(a.cpu(), b)
    assert th.keyed_hist.launches > before
    la = tree_leaves(canonical_carry(card.carry))
    lb = tree_leaves(canonical_carry(cpu.carry))
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


def _check(args, nk, want_counts):
    """One kernel launch on ``[R, B]`` CUDA rows against the plain version,
    bit for bit."""
    before = th.keyed_hist.launches
    s, c = th.keyed_hist_cuda(*args, nk, want_counts)
    s2, c2 = th.keyed_hist_plain(*args, nk, want_counts)
    torch.cuda.synchronize()
    assert th.keyed_hist.launches == before + 1
    assert torch.equal(s, s2)
    if want_counts:
        assert torch.equal(c, c2)
    else:
        assert c is None and c2 is None


def _on_card(arrays, device):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("want_counts", [True, False])
def test_kernel_on_views_at_an_odd_offset(cuda_device, want_counts):
    keys, vals, valid = _inputs(7, (64,), 1024, 8192)
    args = [torch.cat([a.reshape(-1)[:1], a.reshape(-1)])[1:].view(64, 1024)
            for a in _on_card((keys, vals, valid), cuda_device)]
    assert all(a.data_ptr() % 16 for a in args)
    _check(args, 8192, want_counts)


@pytest.mark.parametrize("b", [100, 300, 1000, 1028])
def test_kernel_rows_not_a_multiple_of_16(cuda_device, b):
    keys, vals, valid = _inputs(b, (33,), b, 997)
    for want_counts in (True, False):
        _check(_on_card((keys, vals, valid), cuda_device), 997, want_counts)


@pytest.mark.parametrize("r", [1, 3, 131, 20000])
def test_kernel_rows_below_and_far_above_the_persistent_grid(cuda_device, r):
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    keys, vals, valid = _inputs(r, (r,), 512, 499)
    args = _on_card((keys, vals, valid), cuda_device)
    for want_counts in (True, False):
        _check(args, 499, want_counts)
    if r == 20000:
        smem, n = th._device_info(cuda_device.index or 0)
        assert n == sms
        assert th._plan(r, 512, 499, False, True, smem, n).grid < r // 8


@pytest.mark.parametrize("nk", [8192, 16384])
def test_kernel_wide_tables_with_counts(cuda_device, nk):
    keys, vals, valid = _inputs(nk, (512,), 1024, nk)
    _check(_on_card((keys, vals, valid), cuda_device), nk, True)
    # Records past 1,024 a row take more than one ring stage per row.
    keys, vals, valid = _inputs(nk + 1, (40,), 2048 + 16, nk)
    _check(_on_card((keys, vals, valid), cuda_device), nk, True)


@pytest.mark.parametrize("dist", ["zipf", "hot-key"])
def test_kernel_on_skewed_keys(cuda_device, dist):
    rng = np.random.RandomState(11)
    r, b, nk = 256, 1024, 997
    if dist == "zipf":
        p = np.arange(1, nk + 1, dtype=np.float64) ** -1.2
        keys = rng.choice(nk, (r, b), p=p / p.sum())
    else:
        keys = np.where(rng.rand(r, b) < 0.9, rng.randint(nk),
                        rng.randint(0, nk, (r, b)))
    vals = rng.randint(-1000, 1000, (r, b))
    valid = rng.rand(r, b) < 0.7
    args = _on_card((keys.astype(np.int32), vals.astype(np.int32), valid),
                    cuda_device)
    for want_counts in (True, False):
        _check(args, nk, want_counts)


def test_kernel_from_two_threads_on_two_streams(cuda_device):
    import threading
    shapes = [(512, 1024, 8192, True), (4096, 1024, 997, False)]
    inputs = [_on_card(_inputs(i, (r,), b, nk), cuda_device)
              for i, (r, b, nk, _) in enumerate(shapes)]
    expect = [th.keyed_hist_plain(*a, nk, counts)
              for a, (_, _, nk, counts) in zip(inputs, shapes)]
    torch.cuda.synchronize()
    got = [[], []]
    errors = []

    def run(i):
        try:
            stream = torch.cuda.Stream(cuda_device)
            with torch.cuda.stream(stream):
                nk, counts = shapes[i][2], shapes[i][3]
                for _ in range(20):
                    got[i].append(th.keyed_hist_cuda(*inputs[i], nk, counts))
            stream.synchronize()
        except Exception as e:  # reported below, on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    for i, (s2, c2) in enumerate(expect):
        assert len(got[i]) == 20
        for s, c in got[i]:
            assert torch.equal(s, s2)
            assert (c is None and c2 is None) or torch.equal(c, c2)


def test_spanning_job_on_two_slice_workers_equals_cpu_control(cuda_device,
                                                              tmp_path):
    """The spanning job deployed by a ``SlotPoolScheduler`` on two
    in-process ``SliceWorker``s on the card (each driven by its own
    thread): each slice runs on its worker's device, records cross the
    cut edge over the wire, and every downstream fence digest equals a
    CPU run of the same slice over the exported records."""
    import json
    import socket
    import threading
    import time

    from clonos_tpu_torch.api.feeds import ListFeedReader
    from clonos_tpu_torch.examples import spanning
    from clonos_tpu_torch.parallel import transport as tp
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    from clonos_tpu_torch.runtime.leader import FileLeaderElection
    from clonos_tpu_torch.runtime.remote import JobMasterServer
    from clonos_tpu_torch.runtime.scheduler import (SliceWorker,
                                                    SlotPoolScheduler)

    lines = [((i * 37) % 997, 1 + i % 5) for i in range(600)]
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def serve():
        conn, _ = srv.accept()
        conn.sendall("".join(f"{k}:{v}\n" for k, v in lines).encode())
        time.sleep(30)
        conn.close()

    threading.Thread(target=serve, daemon=True).start()
    kw = dict(steps_per_epoch=4, log_capacity=512, max_epochs=64,
              inflight_ring_steps=64, seed=7, logical_time=True)
    jm = JobMasterServer(heartbeat_timeout_s=10.0)
    election = FileLeaderElection(str(tmp_path / "jm.lease"), "jm-0",
                                  lease_ttl_s=60.0)
    assert election.try_acquire()
    statuses = {"a": [], "b": []}
    workers = {eid: SliceWorker(eid, jm.address,
                                lease_path=str(tmp_path / "jm.lease"),
                                slots=2, emit=statuses[eid].append,
                                device=cuda_device)
               for eid in ("a", "b")}
    stop = threading.Event()
    errors = []

    def drive(w):
        try:
            while not stop.is_set():
                if not w.step():
                    time.sleep(0.01)
        except Exception as e:  # reported below, on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=drive, args=(w,), daemon=True)
               for w in workers.values()]
    for t in threads:
        t.start()
    sched = SlotPoolScheduler(
        jm, election, "clonos_tpu_torch.examples.spanning:build_job",
        runner_kw=kw, feed_batch=4, target_epochs=8, complete_every=2,
        checkpoint_root=str(tmp_path / "ck"), deploy_timeout_s=120.0,
        device=cuda_device)
    before = th.keyed_hist.launches
    try:
        assert {jm.info(w)["device"].split(":")[0] for w in "ab"} == {"cuda"}
        assert sched.deploy(external_feeds={0: {
            "kind": "socket", "host": "127.0.0.1",
            "port": srv.getsockname()[1], "num_subtasks": 1}}) == \
            {0: "a", 1: "b"}
        deadline = time.monotonic() + 120
        while not any(s.get("finished") == 1 for s in statuses["b"]):
            assert not errors, errors
            assert time.monotonic() < deadline, "slices never finished"
            time.sleep(0.05)
        assert th.keyed_hist.launches > before
        for w in workers.values():
            for sl in w.slices.values():
                assert sl.runner.device.type == "cuda"
        cl = tp.ControlClient(sched._export_addr[1])
        rt, resp = cl.call(tp.FETCH_EDGE, tp.pack_json(
            {"edge": 1, "start": 0, "count": 1 << 20}))
        cl.close()
        assert rt == tp.EDGE_DATA
        hlen = int.from_bytes(resp[:4], "little")
        recs = np.frombuffer(resp[4 + hlen:], np.int32).reshape(-1, 2)
        sub, _v, feeds, _e = spanning.build_job().subgraph(
            [2, 3], feed_batch_size=4)
        ctrl = ClusterRunner(sub, device="cpu", **kw)
        ctrl.executor.register_feed(feeds[1],
                                    ListFeedReader([recs.tolist()]))
        want = {}
        for _ in range(8):
            closed = ctrl.executor.epoch_id
            ctrl.run_epoch(complete_checkpoint=(closed % 2 == 0))
            want[ctrl.global_step] = ctrl.state_digest()
        got = {s["global_step"]: s["digest"] for s in statuses["b"]
               if "group" in s}
        assert len(got) == 8 and got == want, json.dumps(got)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sched.close()
        for w in workers.values():
            w.close()
        jm.close()
        srv.close()


def test_warm_launches_count_apart_and_first_step_warm(cuda_device):
    """Launches under ``counting_as_warm`` (the first-step warm's) go to
    the warm counters only, on the thread that opened it; the warm of a
    small job on the card leaves its carry bit-identical."""
    from clonos_tpu_torch.utils.compile_cache import aot_lower_first_step
    keys, vals, valid = _inputs(5, (4,), 64, 16)
    args = [torch.from_numpy(a).to(cuda_device) for a in (keys, vals, valid)]
    counts = lambda: (th.keyed_hist.launches, th.keyed_hist.launches_counts,
                      th.keyed_hist.warm_launches,
                      th.keyed_hist.warm_launches_counts)
    a = counts()
    with th.counting_as_warm():
        th.keyed_hist(*args, 16)
        th.keyed_hist(*args, 16, want_counts=False)
    b = counts()
    assert (b[0] - a[0], b[1] - a[1], b[2] - a[2], b[3] - a[3]) == \
        (0, 0, 2, 1)
    th.keyed_hist(*args, 16)
    c = counts()
    assert (c[0] - b[0], c[2] - b[2]) == (1, 0)
    env = StreamEnvironment(name="warm", num_key_groups=8)
    (env.synthetic_source(vocab=11, batch_size=8, parallelism=2)
        .key_by().window_count(num_keys=11, window_size=4).sink())
    ex = LocalExecutor(env.build(), steps_per_epoch=8, log_capacity=256,
                       max_epochs=8, inflight_ring_steps=16, seed=3,
                       device="cuda")
    ex.run_epoch()
    before = [x.clone() for x in tree_leaves(ex.carry)]
    launches = th.keyed_hist.launches
    warm = aot_lower_first_step(ex)
    assert warm is not None and warm.device.startswith("cuda")
    assert th.keyed_hist.launches == launches
    assert all(torch.equal(x, y) for x, y in zip(before,
                                                 tree_leaves(ex.carry)))


def test_fed_blocks_pack_into_pinned_memory_behind_copies_in_flight(
        cuda_device):
    """Fed blocks staged in pinned memory: after two blocks, with the
    stream held busy, four are pulled back to back, so each one's copy is
    still queued while the next is packed; after a synchronise every
    block's batch (keys, values, zero timestamps, valid) equals the zeroed
    three-plane packing pulled lane by lane from a twin reader, and every
    ``feed.pack`` span says ``pinned`` 1."""
    from clonos_tpu_torch import obs
    from clonos_tpu_torch.api.feeds import ListFeedReader
    k, p, b = 32, 8, 256
    rng = np.random.RandomState(9)
    # Ragged steps; lanes 1 and 2 run dry in the second and fourth blocks.
    lens = [8 * k * b] + [k * b + 77, 3 * k * b + 5] + [8 * k * b] * (p - 3)
    parts = [list(zip(rng.randint(-5, 1000, n).tolist(),
                      rng.randint(-9, 9, n).tolist())) for n in lens]
    reader = lambda: ListFeedReader(parts, records_per_pull=b - 3)
    env = StreamEnvironment(name="pinned-feed", num_key_groups=16,
                            default_edge_capacity=p * b)
    (env.host_source(batch_size=b, parallelism=p)
        .key_by().reduce(num_keys=97, parallelism=p).sink(parallelism=p))
    ex = LocalExecutor(env.build(), steps_per_epoch=k, log_capacity=1 << 10,
                       max_epochs=8, inflight_ring_steps=2 * k, seed=4,
                       device=cuda_device)
    ex.register_feed(0, reader())
    tr = obs.configure("pinned-feed")
    try:
        # Two blocks first, so the pinned pool holds a block and the next
        # pack needs no new pinned allocation (which may wait for the card).
        got = [ex._pull_feeds(k)[0] for _ in range(2)]
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)       # the copies queue behind it
        got += [ex._pull_feeds(k)[0] for _ in range(4)]
        torch.cuda.synchronize()
        packs = [x for x in tr.records() if x["name"] == "feed.pack"]
    finally:
        obs.reset()
    assert [x["args"]["pinned"] for x in packs] == [1] * 6
    twin = reader()
    for batch in got:
        host = np.zeros((3, k, p, b), np.int32)
        for i in range(p):
            ks, vs, cnt = twin.pull_block(i, b, k)
            host[0, :, i], host[1, :, i] = ks, vs
            host[2, :, i] = np.arange(b)[None, :] < cnt[:, None]
        keys, values, ts, valid = (x.cpu().numpy() for x in batch)
        assert batch.valid.dtype == torch.bool
        np.testing.assert_array_equal(keys, host[0])
        np.testing.assert_array_equal(values, host[1])
        np.testing.assert_array_equal(ts, np.zeros_like(host[0]))
        np.testing.assert_array_equal(valid, host[2] != 0)


# --- the interval join's keyed rank (ops/csrc/keyed_rank.cu) ----------------

def _rank_inputs(seed, P, G, B, nk, kind="mixed"):
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, nk, (P, G * B)).astype(np.int32)
    valid = rng.rand(P, G * B) < 0.7
    if kind == "one-key":
        keys[:] = nk - 1
    elif kind == "all-invalid":
        valid[:] = False
    return keys, valid


def _check_rank(keys, valid, G, B, nk):
    """The kernel's rank and through equal the plain version's, bit for
    bit, after a synchronise; one call counted."""
    from clonos_tpu_torch.ops import keyrank
    before = keyrank.keyed_rank.launches
    rank, through = keyrank.keyed_rank(keys, valid, G, B, nk)
    torch.cuda.synchronize()
    assert keyrank.keyed_rank.launches == before + 1
    want_rank, want_through = keyrank.keyed_rank_plain(
        keys.cpu(), valid.cpu(), G, B, nk)
    assert rank.dtype == torch.int64 and through.dtype == torch.int32
    assert torch.equal(rank.cpu(), want_rank)
    assert torch.equal(through.cpu(), want_through)


@pytest.mark.parametrize("P,G,B", [(1, 64, 256), (32, 4, 256)],
                         ids=["replay", "fill"])
def test_keyed_rank_equals_plain_at_the_join_cell_shapes(cuda_device, P, G,
                                                         B):
    keys, valid = _rank_inputs(P * G, P, G, B, 211)
    _check_rank(*_on_card((keys, valid), cuda_device), G, B, 211)


@pytest.mark.parametrize("P,G,B,nk,kind", [
    (2, 8, 256, 211, "all-invalid"),
    (2, 8, 256, 211, "one-key"),
    (3, 4, 64, 1, "mixed"),
    (2, 4, 256, 30000, "mixed"),      # the table in global scratch
    (1, 8, 256, 70000, "one-key"),
    (3, 5, 100, 211, "mixed"),        # a ragged step
    (2, 3, 2500, 4096, "mixed"),      # three tiles of a step
    (5, 1, 256, 211, "mixed"),
], ids=["all-invalid", "one-key", "nk1", "nk30000", "nk70000-one-key",
        "ragged-B100", "B2500", "G1"])
def test_keyed_rank_edge_cases(cuda_device, P, G, B, nk, kind):
    keys, valid = _rank_inputs(B + nk, P, G, B, nk, kind)
    _check_rank(*_on_card((keys, valid), cuda_device), G, B, nk)


def test_keyed_rank_on_views_at_an_odd_offset(cuda_device):
    keys, valid = _rank_inputs(9, 2, 8, 256, 211)
    k, v = (torch.cat([a.reshape(-1)[:1], a.reshape(-1)])[1:].view(a.shape)
            for a in _on_card((keys, valid), cuda_device))
    assert k.data_ptr() % 16 != 0
    _check_rank(k, v, 8, 256, 211)


def test_keyed_rank_refuses_a_shape_outside_its_extents(cuda_device):
    from clonos_tpu_torch.ops import keyrank
    keys, valid = _on_card(_rank_inputs(1, 2, 4, 16, 11), cuda_device)
    with pytest.raises(ValueError):
        keyrank.keyed_rank_cuda(keys, valid, 4, 17, 11)
    with pytest.raises(ValueError):
        keyrank.keyed_rank_cuda(keys, valid, 4, 16, 0)


def _join_side(rng, K, P, B, nk):
    keys = rng.randint(-1, nk + 1, (K, P, B)).astype(np.int32)
    vals = rng.randint(-50, 50, (K, P, B)).astype(np.int32)
    ts = (np.arange(K)[:, None, None] * 3
          + rng.randint(-4, 5, (K, P, B))).astype(np.int32)
    valid = rng.rand(K, P, B) < 0.7
    keys, vals, ts = (np.where(valid, x, 0) for x in (keys, vals, ts))
    return keys, vals, ts, valid


def test_join_grouped_block_on_card_equals_cpu_and_counts_groups(
        cuda_device):
    """``IntervalJoinOperator.process_block`` on the card equals the same
    call on the CPU, and launches the rank kernel once a group of G
    steps; under ``counting_as_warm`` its calls count apart."""
    from clonos_tpu_torch.api import operators as to
    from clonos_tpu_torch.api.records import RecordBatch
    from clonos_tpu_torch.ops import keyrank
    K, P, B, nk = 128, 4, 64, 211
    op = to.IntervalJoinOperator(num_keys=nk, window=4, interval=1 << 30,
                                 capacity=64)
    G = op.group_size(K, P, B)
    assert 1 < G < K and K % G == 0
    rng = np.random.RandomState(11)
    blocks = [(_join_side(rng, K, P, B, nk), _join_side(rng, K, P, B, nk))
              for _ in range(2)]

    def run(dev):
        ctx = to.BlockContext(
            times=torch.arange(K, dtype=torch.int32, device=dev),
            rng_bits=torch.zeros((K,), dtype=torch.int32, device=dev),
            epoch=torch.zeros((), dtype=torch.int32, device=dev),
            step0=torch.zeros((), dtype=torch.int32, device=dev),
            subtask=torch.arange(P, dtype=torch.int32, device=dev))
        state, outs = op.init_state(P, dev), []
        for left, right in blocks:
            side = lambda s: RecordBatch(*(torch.from_numpy(x).to(dev)
                                           for x in s))
            state, out = op.process_block(state, (side(left), side(right)),
                                          ctx)
            outs.append(out)
        return state, outs

    before = (keyrank.keyed_rank.launches, keyrank.keyed_rank.warm_launches)
    card_state, card_outs = run(cuda_device)
    torch.cuda.synchronize()
    assert (keyrank.keyed_rank.launches - before[0],
            keyrank.keyed_rank.warm_launches - before[1]) == (2 * K // G, 0)
    cpu_state, cpu_outs = run(torch.device("cpu"))
    for k in cpu_state:
        assert torch.equal(card_state[k].cpu(), cpu_state[k]), k
    for a, b in zip(card_outs, cpu_outs):
        for x, y in zip(a, b):
            assert torch.equal(x.cpu(), y)
    launches = keyrank.keyed_rank.launches
    with th.counting_as_warm():
        run(cuda_device)
    torch.cuda.synchronize()
    assert keyrank.keyed_rank.launches == launches
    assert keyrank.keyed_rank.warm_launches - before[1] == 2 * K // G
