"""``chip_smoke.py`` stops every process it starts: what a phase leaves
running (an orphan in a session of its own, multiprocessing's resource
tracker) is killed and reaped before the script exits, whether the run
passed or failed.  Each case runs in a child process, so that this test
process does not become a subreaper."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# The child: imports chip_smoke, replaces its phases with ``run`` below,
# calls main() and prints the pids it left behind and main's exit code.
CHILD = textwrap.dedent("""
    import multiprocessing.resource_tracker as resource_tracker
    import subprocess, sys
    sys.path.insert(0, {root!r})
    import chip_smoke

    left = []

    def run():
        # A grandchild in a session of its own, orphaned when its parent
        # exits: a subreaper gets it back, init would not give it back.
        out = subprocess.run(
            [sys.executable, "-c", "import subprocess, sys; print("
             "subprocess.Popen([sys.executable, '-c', 'import time; "
             "time.sleep(600)'], start_new_session=True, "
             "stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL).pid)"],
            capture_output=True, text=True, check=True).stdout
        left.append(int(out))
        resource_tracker.ensure_running()
        left.append(resource_tracker._resource_tracker._pid)
        if {fail!r}:
            raise chip_smoke.SmokeFailure("a phase failed")
        return 0

    chip_smoke.run = run
    try:
        rc = chip_smoke.main()
    except chip_smoke.SmokeFailure:
        rc = 1
    print("left", *left, "rc", rc, "children", len(chip_smoke.child_pids()))
""")


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


@pytest.mark.skipif(not sys.platform.startswith("linux"),
                    reason="the subreaper is a Linux prctl")
@pytest.mark.parametrize("fail", [False, True], ids=["passed", "failed"])
def test_chip_smoke_leaves_no_process(fail):
    proc = subprocess.run(
        [sys.executable, "-c", CHILD.format(root=str(ROOT), fail=fail)],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
    words = proc.stdout.split()
    orphan, tracker = int(words[1]), int(words[2])
    assert words[3:] == ["rc", "1" if fail else "0", "children", "0"]
    assert not _alive(orphan) and not _alive(tracker)
    # The orphan was killed and said so; the tracker stopped on its own.
    assert "killed 1 processes left running" in proc.stderr
    assert "time.sleep(600)" in proc.stderr
