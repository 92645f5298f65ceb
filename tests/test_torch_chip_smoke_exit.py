"""chip_smoke.py stops every process it starts, and fails without a card.

The script makes itself the reaper of its orphaned descendants and, when
main() ends (passed or failed), stops and reaps what still runs: spawned
worker ranks, multiprocessing's resource tracker, and a process that a
child left behind.  Each case runs in a fresh interpreter, so the test
process itself never becomes a subreaper.
"""

import os
import pathlib
import shutil
import subprocess
import sys
import textwrap
import uuid

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _running(marker: str) -> list[int]:
    """Pids of live processes whose command line holds ``marker``."""
    pids = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            with open(f"/proc/{d}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if marker in cmd and state != "Z":
            pids.append(int(d))
    return pids


def test_stop_children_reaps_ranks_tracker_and_orphans():
    # A unique sleep length marks the orphan: "sh" exits at once and leaves
    # its "sleep" to be reparented, to the script since it is a subreaper.
    marker = f"{300 + uuid.uuid4().int % 10_000 / 1000:.3f}"
    script = textwrap.dedent(f"""
        import multiprocessing, subprocess, sys, time
        sys.path.insert(0, {str(ROOT)!r})
        import chip_smoke
        if __name__ == "__main__":
            chip_smoke.adopt_orphans()
            rank = multiprocessing.get_context("spawn").Process(target=time.sleep, args=(300,), daemon=True)
            rank.start()
            subprocess.run(["sh", "-c", "sleep {marker} >/dev/null 2>&1 & exit 0"], check=True)
            before = chip_smoke._children()
            chip_smoke.stop_children(grace=5.0)
            print(len(before), len(chip_smoke._children()))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # The rank, the resource tracker and the orphaned sleep: all stopped.
    assert out.stdout.split() == ["3", "0"], (out.stdout, out.stderr)
    assert "sleep " + marker in out.stderr
    assert _running("sleep " + marker) == []


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No card (CUDA hidden): a non-zero exit and no result line, also from
    a directory that holds chip_smoke.py alone."""
    where = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        where = tmp_path
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=where, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "torch.cuda.is_available() is false" in out.stderr
