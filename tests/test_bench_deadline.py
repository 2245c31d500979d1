"""bench.py's bounded run: the process must print ONE parseable JSON
line within its deadline however its workers fail or hang.

These tests run bench.py as a real subprocess with its worker test hook
faking dead / hung / healthy workers, and assert a parseable line lands
on stdout before the deadline. Reference anchor for the bounded-run
discipline: linux/instrumented_benchmark.cpp:107-142.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent / "bench.py"


def _run(env_extra: dict, timeout: float = 90.0):
    env = dict(os.environ)
    env.update(env_extra)
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, str(BENCH)],
                          capture_output=True, text=True, env=env,
                          timeout=timeout)
    return proc, time.monotonic() - t0


def _last_json(stdout: str) -> dict:
    lines = [ln for ln in stdout.splitlines() if ln.strip().startswith("{")]
    assert lines, f"no JSON line on stdout: {stdout!r}"
    return json.loads(lines[-1])


def test_dead_backend_emits_error_line_within_deadline(tmp_path):
    """Every worker dies without a result (a dead backend): the
    zero-artifact error schema must print, in seconds."""
    proc, wall = _run({
        "LFS_BENCH_DEADLINE_S": "60",
        "LFS_BENCH_WORKER_CMD": f"{sys.executable} -c pass",
    })
    line = _last_json(proc.stdout)
    assert line["metric"] == "flagstat_words_per_sec"
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0
    assert "error" in line
    assert proc.returncode == 1
    assert wall < 45.0


def test_watchdog_fires_through_a_hung_worker(tmp_path):
    """A worker that hangs forever (main thread stuck in subprocess.run)
    must not block the final line: the watchdog thread prints the
    fallback and hard-exits at the deadline."""
    proc, wall = _run({
        "LFS_BENCH_DEADLINE_S": "6",
        "LFS_BENCH_WORKER_CMD": "sleep 600",
    })
    line = _last_json(proc.stdout)
    assert line["value"] == 0.0
    assert "deadline" in line["error"]
    assert proc.returncode == 1
    assert wall < 40.0


def test_healthy_workers_print_cross_process_line(tmp_path):
    """Two agreeing fake workers produce a cross_process line that names
    the device."""
    worker = tmp_path / "fake_worker.py"
    res = {
        "backend": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
        "n_words": 1024, "mode": "full_parity", "kernel_ms": 0.18,
        "bytes_per_s": 7.4e11, "words_per_s": 3.7e11,
        "roofline_gbs": 750.0, "window_roofline_gbs": 750.0,
        "defended_roofline_gbs": 752.0, "roofline_kind": "read_sum",
        "vs_roofline": 0.97, "fit_residual": 0.01, "fit_dispersion": 0.02,
        "dispatch_ms": 0.05, "rejected_samples": 0,
    }
    worker.write_text(
        "import json\n"
        f"print('WORKER_RESULT ' + json.dumps({res!r}))\n")
    proc, _ = _run({
        "LFS_BENCH_DEADLINE_S": "60",
        "LFS_BENCH_WORKER_CMD": f"{sys.executable} {worker}",
    })
    line = _last_json(proc.stdout)
    assert line["agreement"] == "cross_process"
    assert line["device_kind"] == "NVIDIA H100 80GB HBM3"
    assert proc.returncode == 0
