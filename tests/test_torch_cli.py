"""PyTorch port, the command line (``python -m clonos_tpu_torch``): ``info``
prints the reference CLI's JSON for the two wordcount builders; ``run
--device cpu`` exits 0 with the reference's top-level keys and metric
names (and its deterministic metric values); the default device is the
card, so without one ``run`` raises; a ``worker`` refuses an incomplete
multi-host bootstrap, and two workers given a complete one join one
process group as processes 0 and 1; ``verify --quick --report json``
exits 0 with the reference CLI's line, a seeded bug exits 1 and writes a
``.chaos`` schedule the port's ``soak`` takes and its ``.jsonl`` trace,
and bad arguments exit 2; ``lint`` and ``analyze`` exit 0 clean, 1 on a
finding or a pin that does not match, 2 on a bad argument (their runs
over the whole port are in ``test_torch_lint.py`` and
``test_torch_analysis.py``). Tolerance: exact."""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from clonos_tpu import cli as jcli
from clonos_tpu_torch import cli

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JOB = "clonos_tpu_torch.examples.wordcount:build_job"


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("builder", ["build_job", "build_socket_job"])
def test_info_equals_reference_cli(builder):
    got = json.loads(_stdout(cli.main, [
        "info", f"clonos_tpu_torch.examples.wordcount:{builder}"]))
    want = json.loads(_stdout(jcli.main, [
        "info", f"examples.wordcount:{builder}"]))
    assert got == want
    assert got["total_subtasks"] == (12 if builder == "build_job" else 3)


def test_run_on_cpu_prints_the_reference_keys():
    proc = subprocess.run(
        [sys.executable, "-m", "clonos_tpu_torch", "run", _JOB,
         "--device", "cpu", "--epochs", "2", "--steps-per-epoch", "8"],
        cwd=_REPO, env=dict(os.environ, PYTHONPATH=_REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    want = json.loads(_stdout(jcli.main, [
        "run", "examples.wordcount:build_job", "--epochs", "2",
        "--steps-per-epoch", "8"]).strip().splitlines()[-1])
    assert sorted(got) == sorted(want) == ["epochs", "job", "metrics",
                                           "wall_s"]
    assert (got["job"], got["epochs"]) == (want["job"], want["epochs"])
    assert sorted(got["metrics"]) == sorted(want["metrics"])
    pre = f"job.{got['job']}."
    for name in ("supersteps", "epochs", "recovery.replay-lag-steps",
                 "backpressure.inflight-occupancy", "audit.enabled",
                 "audit.last-sealed-epoch", "checkpoint.latest-bytes"):
        assert got["metrics"][pre + name] == want["metrics"][pre + name], \
            name


def test_run_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["run", _JOB, "--epochs", "1"])


@pytest.mark.parametrize("flag", [["--coordinator", "127.0.0.1:1"],
                                  ["--num-processes", "2"],
                                  ["--process-id", "1"]])
def test_worker_refuses_the_multi_host_bootstrap(flag, tmp_path):
    """An incomplete bootstrap (a coordinator without the group's size and
    rank, or those without a coordinator) is refused before anything is
    written."""
    with pytest.raises(SystemExit, match="coordinator"):
        cli.main(["worker", _JOB, "--jm", "127.0.0.1:1",
                  "--checkpoint-dir", str(tmp_path), "--device", "cpu",
                  *flag])
    assert not os.listdir(tmp_path)


def test_worker_joins_a_process_group(tmp_path):
    """Two ``worker`` processes with ``--coordinator file://...
    --num-processes 2`` join one gloo group and register with the
    JobMaster as processes 0 and 1, then run their epochs to the end."""
    from clonos_tpu_torch.runtime import remote
    jm = remote.JobMasterServer(heartbeat_timeout_s=30.0)
    rdv = "file://" + str(tmp_path / "rendezvous")
    procs = []
    try:
        for i in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "clonos_tpu_torch", "worker", _JOB,
                 "--jm", f"{jm.address[0]}:{jm.address[1]}",
                 "--executor-id", f"w{i}", "--checkpoint-dir",
                 str(tmp_path / f"ck{i}"), "--epochs", "1",
                 "--steps-per-epoch", "4", "--logical-time",
                 "--device", "cpu", "--coordinator", rdv,
                 "--num-processes", "2", "--process-id", str(i)],
                cwd=_REPO, env=dict(os.environ, PYTHONPATH=_REPO),
                stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=240) for p in procs]
        for p, (out, err) in zip(procs, outs):
            assert p.returncode == 0, err[-2000:]
            assert json.loads(out.splitlines()[0])["registered"]
        assert sorted(jm.registered()) == ["w0", "w1"]
        assert [(jm.info(f"w{i}")["process_id"],
                 jm.info(f"w{i}")["num_processes"]) for i in range(2)] \
            == [(0, 2), (1, 2)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        jm.close()


# --- verify (the protocol model checker) ----------------------------------

def _run_verify(args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "clonos_tpu_torch", "verify"] + args,
        cwd=_REPO, env=dict(os.environ, PYTHONPATH=_REPO),
        capture_output=True, text=True, timeout=timeout)


def test_cli_verify_quick_report_json_exit_zero():
    from clonos_tpu_torch.verify import MODELS
    p = _run_verify(["--quick", "--report", "json"])
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["ok"] is True and line["quick"] is True
    assert {m["model"] for m in line["models"]} == set(MODELS)
    assert all(m["violations"] == [] for m in line["models"])
    want = json.loads(_stdout(jcli.main, [
        "verify", "--quick", "--report", "json"]).strip())
    assert line == want


def test_cli_verify_seeded_bug_exits_one_with_counterexample(tmp_path):
    p = _run_verify(["--quick", "--model", "lease", "--seed-bug",
                     "lease:no-fencing-check", "--report", "json",
                     "--chaos-out", str(tmp_path)])
    assert p.returncode == 1, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    (m,) = line["models"]
    assert m["violations"][0]["trace"] == ["acquire(0)", "expire",
                                           "acquire(1)"]
    names = os.listdir(tmp_path)
    assert any(n.endswith(".chaos") for n in names)
    assert any(n.endswith(".jsonl") for n in names)
    # the .chaos file is a schedule the port's soak takes as --schedule
    from clonos_tpu_torch.soak.chaos import parse_schedule
    (chaos,) = [n for n in names if n.endswith(".chaos")]
    with open(tmp_path / chaos) as f:
        assert parse_schedule(f.read()).kinds() == ["leader-loss"]


def test_cli_verify_bad_arguments_exit_two():
    assert _run_verify(["--model", "nope"]).returncode == 2
    assert _run_verify(["--seed-bug", "no-colon"]).returncode == 2


# --- lint and analyze ------------------------------------------------------

def _quiet(main, argv):
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, buf.getvalue(), err.getvalue()


def test_cli_lint_exit_codes(tmp_path, monkeypatch):
    """``lint``: 0 on a clean file, 1 on an unwaived finding (0 again
    when the finding is waived), 2 on an unknown ``--rule``; ``--list-
    rules`` prints the registry; ``--report json`` is one line."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "clean.py").write_text("X = 1\n")
    (tmp_path / "bait.py").write_text("import time\nT = time.time()\n")
    (tmp_path / "w").write_text("wallclock bait.py\n")
    assert _quiet(cli.main, ["lint", "clean.py"])[0] == 0
    rc, out, _ = _quiet(cli.main, ["lint", "bait.py", "--report", "json"])
    assert rc == 1 and json.loads(out)["errors"] == 1
    assert _quiet(cli.main, ["lint", "bait.py", "--waivers", "w"])[0] == 0
    assert _quiet(cli.main, ["lint", "bait.py", "--waivers", "w",
                             "--no-waivers"])[0] == 1
    assert _quiet(cli.main, ["lint", "bait.py", "--rule",
                             "entropy"])[0] == 0
    assert _quiet(cli.main, ["lint", "--rule", "nope", "bait.py"])[0] == 2
    rc, out, _ = _quiet(cli.main, ["lint", "--list-rules"])
    assert rc == 0 and "overlap-window" in out and "host-callback" in out


def test_cli_analyze_exit_codes(tmp_path, monkeypatch):
    """``analyze``: 0 clean, 1 on a nondet reach, 1 on a census or
    thread-census pin that does not match (0 when it does), 1 on each
    seeded bug, 2 on an unknown one; the ``--census`` and ``--threads``
    dumps parse."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "op.py").write_text(
        "class Op:\n    def process_block(self, state, ins, ctx):\n"
        "        return state + ctx.times\n")
    (tmp_path / "bad.py").write_text(
        "import time\nclass Op:\n"
        "    def process_block(self, state, ins):\n"
        "        return time.time()\n")
    rc, out, _ = _quiet(cli.main, ["analyze", "op.py", "--report", "json"])
    doc = json.loads(out)
    assert rc == 0 and doc["ok"] is True
    fp, tfp = doc["census_fingerprint"], doc["threads_fingerprint"]
    assert _quiet(cli.main, ["analyze", "bad.py"])[0] == 1
    assert _quiet(cli.main, ["analyze", "op.py", "--expect-census", fp,
                             "--expect-threads", tfp])[0] == 0
    (tmp_path / "pin").write_text(fp + "\n")
    assert _quiet(cli.main, ["analyze", "op.py", "--expect-census",
                             "pin"])[0] == 0
    rc, _, err = _quiet(cli.main, ["analyze", "op.py", "--expect-census",
                                   "0" * 16])
    assert rc == 1 and "census drift" in err
    rc, _, err = _quiet(cli.main, ["analyze", "op.py", "--expect-threads",
                                   "0" * 16])
    assert rc == 1 and "thread-census drift" in err
    rc, out, _ = _quiet(cli.main, ["analyze", "op.py", "--census"])
    assert rc == 0 and json.loads(out)["step_functions"]
    rc, out, _ = _quiet(cli.main, ["analyze", "op.py", "--threads"])
    assert rc == 0 and json.loads(out)["roots"] == []
    from clonos_tpu_torch.analysis import SEEDED_BUGS
    for name in sorted(SEEDED_BUGS):
        assert _quiet(cli.main, ["analyze", "--seed-bug", name])[0] == 1
    assert _quiet(cli.main, ["analyze", "--seed-bug", "nope"])[0] == 2
