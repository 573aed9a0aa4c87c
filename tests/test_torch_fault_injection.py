"""Fault injection on the port: SIGKILL an inverse-rendering run after its
first checkpoint, resume it in a fresh process, and hold the result to an
uninterrupted run bit for bit (the port's counterpart of
tests/test_fault_injection.py).

The runs are ``python -m txr_torch.apps.inverse --device cpu --size 16``
with ``--checkpoint-every 1``.  Each writes its whole state to its
checkpoint file after every step (parameters, Adam's moments and step
count, the step counter and the loss history), the last write after the
last step, so the two files are compared key by key.  Every subprocess
has its own timeout: a hang fails the test and does not stall the suite.
"""

import os
import signal
import subprocess
import sys
import time

from txr_torch.utils.checkpoint import load_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 24
TIMEOUT_S = 120


def _start(ckpt, resume=False):
    cmd = [sys.executable, "-m", "txr_torch.apps.inverse", "--device", "cpu", "--size", "16",
           "--steps", str(STEPS), "--checkpoint", str(ckpt), "--checkpoint-every", "1"]
    # one intra-op thread: parallel test workers share the cores
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen(cmd + (["--resume"] if resume else []), cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(p):
    try:
        out, err = p.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        raise AssertionError(f"the run did not end within {TIMEOUT_S} s")
    assert p.returncode == 0, f"{out}\n{err}"


def test_sigkill_and_resume_equals_uninterrupted(tmp_path):
    ref_ckpt, ckpt = tmp_path / "ref.npz", tmp_path / "run.npz"
    ref = _start(ref_ckpt)
    victim = _start(ckpt)
    try:
        deadline = time.monotonic() + TIMEOUT_S
        while not ckpt.exists():       # written by a rename: whole once it shows
            assert victim.poll() is None, "the run ended before its first checkpoint: " + \
                victim.communicate()[1]
            assert time.monotonic() < deadline, "no checkpoint within the timeout"
            time.sleep(0.005)
        victim.send_signal(signal.SIGKILL)
        victim.communicate(timeout=TIMEOUT_S)
    finally:
        if victim.poll() is None:
            victim.kill()
            victim.communicate()
    assert victim.returncode == -signal.SIGKILL
    killed_at = int(load_arrays(ckpt)[0]["step"])
    assert 1 <= killed_at < STEPS, killed_at

    _finish(_start(ckpt, resume=True))
    _finish(ref)
    got, want = load_arrays(ckpt)[0], load_arrays(ref_ckpt)[0]
    assert int(want["step"]) == STEPS and len(want["losses"]) == STEPS
    assert set(got) == set(want)
    assert any(k.startswith("opt_state.") for k in want)
    for k in want:       # bit for bit: dtype, shape and bytes
        assert (got[k].dtype, got[k].shape) == (want[k].dtype, want[k].shape), k
        assert got[k].tobytes() == want[k].tobytes(), k
