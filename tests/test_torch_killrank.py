"""A killed rank's recovery (counterpart of tests/test_multiprocess.py:61-117
with tests/mp_killhost_child.py): two gloo ranks of the port's Trainer on
partitioned_bcsr (tests/torch_killrank_child.py) run to the end; run again,
rank 1 is SIGKILLed after it reports epoch 2 and rank 0, stuck in a
collective, fails on the process group's 10 s timeout or is killed; both are
relaunched with fit(resume=True). The resumed run starts after the last
epoch rank 0 saved and reaches the uninterrupted final losses within rtol
1e-6 (han_tpu's tolerance). Every wait has a deadline, so a hang fails the
test."""

import os
import pathlib
import select
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
CHILD = ROOT / "tests" / "torch_killrank_child.py"
EPOCHS = 6
WAIT_S = 60  # for one launch of both ranks to finish


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(ckpt) -> list[subprocess.Popen]:
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    port = str(free_port())
    return [subprocess.Popen([sys.executable, str(CHILD), str(r), port, str(ckpt), str(EPOCHS)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             env=env, cwd=ROOT) for r in range(2)]


def finish(procs) -> list[str]:
    """Both ranks' output; each must exit 0 within WAIT_S."""
    deadline = time.monotonic() + WAIT_S
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a rank did not finish within {WAIT_S} s")
        assert p.returncode == 0, outs[-1][-3000:]
    return outs


def lines(out: str, tag: str) -> list[list[str]]:
    return [line.split()[1:] for line in out.splitlines() if line.startswith(tag)]


def test_killed_rank_resumes_to_the_uninterrupted_losses(tmp_path):
    ref = lines(finish(launch(tmp_path / "ref"))[0], "FINAL")[0]

    procs = launch(tmp_path / "kill")
    deadline, seen = time.monotonic() + WAIT_S, []
    try:
        while not seen or seen[-1] < 2:
            left = deadline - time.monotonic()
            assert left > 0 and select.select([procs[1].stdout], [], [], left)[0], \
                "rank 1 never reported epoch 2"
            line = procs[1].stdout.readline()
            assert line, f"rank 1 ended early: {procs[1].wait()}"
            if line.startswith("EPOCH"):
                seen.append(int(line.split()[1]))
        procs[1].send_signal(signal.SIGKILL)  # the dead rank
        try:  # rank 0 waits in a collective: it fails on the timeout, or goes
            procs[0].communicate(timeout=30)
        except subprocess.TimeoutExpired:
            procs[0].kill()
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=10)
    saved = sorted(int(p.stem) for p in (tmp_path / "kill").rglob("*.pt"))
    assert saved and saved[-1] >= 1, saved

    outs = finish(launch(tmp_path / "kill"))
    for out in outs:
        epochs = [int(e) for e, _ in lines(out, "EPOCH")]
        assert epochs == list(range(saved[-1] + 1, EPOCHS)), (epochs, saved)
        np.testing.assert_allclose([float(x) for x in lines(out, "FINAL")[0]],
                                   [float(x) for x in ref], rtol=1e-6)
