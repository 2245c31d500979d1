#!/usr/bin/env python3
"""Headline benchmark: flagstat throughput of the bit-sliced kernel on one
GPU against the device's memory-read roofline.

Workload: 64M uniform-random 16-bit FLAG words, bit-exact counters
validated against the host oracle before timing (the reference validates
every benchmark iteration against FLAGSTAT_scalar,
linux/instrumented_benchmark.cpp:181-208; its min/avg + memcpy
speed-of-light method is instrumented_benchmark.cpp:107-142,456-544).

The headline row is the full-parity kernel (all 32 counters); the plain
XLA formulation of the same counts is measured between the same roofline
brackets and published as the ``alt`` row. Without a GPU the benchmark
fails: it never times another device in the card's place.

Self-defending measurement:

  1. every timed call runs on a FRESH salted device buffer, so an
     execution cache keyed on (executable, input buffers) can never hit;
  2. kernel time is the SLOPE of a linear fit of total time over >= 3
     in-jit repetition counts (intercept = dispatch overhead), with
     residual and median-vs-min dispersion gates;
  3. any sample implying throughput above the device's NOMINAL memory
     bandwidth (bench.harness.HBM_NOMINAL) is rejected and remeasured;
  4. vs_baseline is computed in-window: roofline samples BRACKET the
     kernel fit, and the denominator is raised by the kernel's own read
     rate when it exceeds them (a conformant kernel reading bytes at X
     proves the read floor >= X) — the ratio is honest and capped at 1.0;
  5. the whole measurement runs in TWO fresh worker processes and the
     result only prints if they agree within 5%;
  6. each worker keeps the FASTER of two gate-passing fits — the
     reference's min-over-iterations discipline
     (instrumented_benchmark.cpp:107-142).

Prints ONE JSON line:
  {"metric": "flagstat_words_per_sec", "value": ..., "unit": "words/s",
   "vs_baseline": <fraction of measured memory read roofline>, ...}
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


N_WORDS = 64 * 1024 * 1024
AGREE_PCT = 5.0           # cross-process reproduction tolerance
MAX_ATTEMPTS = 4          # in-process remeasure attempts
ALT_ATTEMPTS = 3          # alt-row fit attempts (1 + 2 refits)
MAX_WORKERS = 4           # worker launches before giving up
WALL_BUDGET_S = 3600.0    # stop launching new workers past this
DEADLINE_S = _env_f("LFS_BENCH_DEADLINE_S", 1800.0)
#   hard wall for the WHOLE run: a watchdog prints the best available
#   structured line (results-so-far > zero-artifact error) and exits, so
#   one parseable line always lands however a worker hangs

_EMIT_LOCK = threading.Lock()
_EMITTED = threading.Event()
_RESULTS: list[dict] = []   # valid worker results, shared with watchdog
_REAL_MONOTONIC = time.monotonic   # captured at import: the watchdog must
#   keep real wall time even when tests monkeypatch time.monotonic to a
#   fake clock (they do, to simulate budget exhaustion)
_CURRENT_WORKER: list = []         # [Popen] while a worker subprocess is live


def _alt_row(alt_mode: str, n_words: int, roof: float, post: float,
             fit_fn, bracket_fn, spec: float) -> dict | None:
    """Measure the secondary (alt) row with bounded retries.

    ``fit_fn`` produces one kernel_time_fit sample; ``bracket_fn`` one
    gate-passing roofline sample (NaN allowed). Each attempt is
    bracketed by the previous roofline sample (the headline's post
    sample on attempt 0) and one fresh sample, so the row shares its
    window with its own denominator. Returns the accepted row dict or
    None after ALT_ATTEMPTS gate rejections (the gates are the
    headline's: fit ok, dispersion, nominal-bandwidth cap)."""
    from libflagstats_tpu.bench.harness import DISPERSION_MAX

    prev_bracket = post
    for alt_attempt in range(ALT_ATTEMPTS):
        fit_alt = fit_fn()
        post2 = bracket_fn()
        bks = [b for b in (prev_bracket, post2) if b == b]
        alt_window = (sum(bks) / len(bks)) if bks else roof
        prev_bracket = post2   # next retry brackets against fresh samples
        alt_bps = 2.0 * n_words / fit_alt.slope_s
        if (fit_alt.ok and fit_alt.dispersion < DISPERSION_MAX
                and alt_bps <= spec * 1.02):
            return {
                "mode": alt_mode,
                "kernel_ms": fit_alt.slope_s * 1e3,
                "bytes_per_s": alt_bps,
                "vs_roofline": alt_bps / max(alt_window, alt_bps),
                "vs_defended": alt_bps / roof,
                "window_roofline_gbs": alt_window / 1e9,
            }
        print(f"[bench] alt row attempt {alt_attempt} rejected by gates "
              f"(ok={fit_alt.ok} disp={fit_alt.dispersion:.3f}); "
              f"{'retrying' if alt_attempt + 1 < ALT_ATTEMPTS else 'giving up'}",
              file=sys.stderr)
    return None


def _measure_worker() -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from libflagstats_tpu import flags as FL
    from libflagstats_tpu.bench.harness import (
        DISPERSION_MAX,
        defended_roofline,
        hbm_nominal_bytes_per_s,
        kernel_time_fit,
        roofline_fit,
    )
    from libflagstats_tpu.bench.refcache import oracle_counters
    from libflagstats_tpu.config import enable_compilation_cache
    from libflagstats_tpu.ops.pallas_kernels import (
        flagstat_pallas,
        stream_sums_pallas,
    )
    from libflagstats_tpu.ops.xla_ops import stream_sums_xla
    from libflagstats_tpu.oracle import generate_flags

    enable_compilation_cache()
    backend = jax.default_backend()
    if backend != "gpu":
        return {"error": f"no GPU (JAX backend {backend!r}): the benchmark "
                         "measures the card and nothing in its place"}
    spec = hbm_nominal_bytes_per_s()
    device = jax.devices()[0]
    n_words = N_WORDS
    ks = (4, 64, 260)
    x_host = generate_flags(n_words, seed=0, full_range=True)
    x = jax.block_until_ready(jnp.asarray(x_host))

    def body(a):
        return jnp.concatenate(stream_sums_pallas(a))

    def body_alt(a):
        return jnp.concatenate(stream_sums_xla(a))

    # correctness gate: bit-exact vs host oracle in both kernel modes,
    # disk-cached with a source-hash key (see bench/refcache.py)
    ref = oracle_counters(x_host, n_words, seed=0, full_range=True)
    got = np.asarray(jax.jit(lambda a: flagstat_pallas(a, n=n_words))(x),
                     dtype=np.int64)
    got_rep = np.asarray(
        jax.jit(lambda a: flagstat_pallas(a, n=n_words, report=True))(x),
        dtype=np.int64)
    idx = list(FL.REPORT_COUNTERS)
    if not ((got == ref).all() and (got_rep[idx] == ref[idx]).all()):
        print(f"expected {ref}\ngot      {got}", file=sys.stderr)
        return {"error": "counter mismatch vs oracle"}

    # same-process roofline with its own agreement protocol
    roof, roof_name = defended_roofline(2 * n_words, ks=ks, with_kind=True)
    if roof != roof:
        return {"error": "roofline measurement failed"}

    def roof_bracket() -> float:
        """One gate-passing roofline sample taken NOW (best candidate):
        vs_baseline is computed against samples BRACKETING the accepted
        kernel fit (mean of pre/post), so both sides share a window."""
        roofs = roofline_fit(2 * n_words, ks=ks)
        good = [v["bytes_per_s"] for v in roofs.values()
                if v["fit"].ok and v["fit"].dispersion < DISPERSION_MAX
                and v["bytes_per_s"] <= spec * 1.02]
        return max(good) if good else float("nan")

    rejected = 0
    last = None
    accepted = []   # (fit, t_kernel, bps, roof_window) that passed gates
    for attempt in range(MAX_ATTEMPTS):
        pre = roof_bracket()
        fit = kernel_time_fit(body, x, ks=ks,
                              salt_base=(time.time_ns() >> 10) & 0x3FFF)
        post = roof_bracket()
        brackets = [b for b in (pre, post) if b == b]
        roof_window = (sum(brackets) / len(brackets)) if brackets else roof
        t_kernel = fit.slope_s
        bps = 2.0 * n_words / t_kernel
        last = (fit, t_kernel, bps, roof_window)
        print(f"[bench] attempt {attempt}: slope={t_kernel*1e3:.4f}ms "
              f"({bps/1e9:.1f} GB/s) intercept={fit.intercept_s*1e3:.1f}ms "
              f"residual={fit.rel_residual:.3f} dispersion={fit.dispersion:.3f}",
              file=sys.stderr)
        # physical gate: nothing reads device memory above the part's
        # nominal bandwidth — a sample above it is an artifact however
        # well it reproduces
        if (not fit.ok or fit.dispersion >= DISPERSION_MAX
                or bps > spec * 1.02):
            rejected += 1
            continue
        accepted.append((fit, t_kernel, bps, roof_window))
        # min-over-iterations discipline (the reference reports the MIN
        # over 20 iterations, linux/instrumented_benchmark.cpp:107-142):
        # keep the faster of two gate-passing fits
        if len(accepted) >= 2:
            break
    if not accepted:
        fit, t_kernel, bps, roof_window = last
        return {
            "error": "no physically-plausible sample after "
                     f"{MAX_ATTEMPTS} attempts",
            "kernel_ms": t_kernel * 1e3,
            "roofline_gbs": roof / 1e9,
        }
    fit, t_kernel, bps, roof_window = min(accepted, key=lambda s: s[1])

    # Denominator: the best-evidenced read floor for these bytes — the
    # bracketed in-window roofline, raised by the kernel's own observed
    # read rate when that exceeds it (bounded: accepted samples already
    # satisfy the nominal-bandwidth cap). The raw in-window roofline
    # ships alongside (window_roofline_gbs).
    denom = max(roof_window, bps)

    # secondary row: the plain XLA formulation of the same counts,
    # bracketed by the headline's post-sample plus one fresh sample
    alt = _alt_row(
        "xla_full_parity", n_words, roof, post,
        fit_fn=lambda: kernel_time_fit(
            body_alt, x, ks=ks, salt_base=(time.time_ns() >> 10) & 0x3FFF),
        bracket_fn=roof_bracket, spec=spec)

    return {
        "backend": backend,
        "device_kind": device.device_kind,
        "device_count": len(jax.devices()),
        "n_words": n_words,
        "mode": "full_parity",
        "alt": alt,
        "kernel_ms": t_kernel * 1e3,
        "bytes_per_s": bps,
        "words_per_s": n_words / t_kernel,
        "roofline_gbs": denom / 1e9,
        "window_roofline_gbs": roof_window / 1e9,
        "defended_roofline_gbs": roof / 1e9,
        "roofline_kind": roof_name,
        "vs_roofline": bps / denom,
        # UNCAPPED ratio vs the defended multi-sample roofline
        "vs_defended": bps / roof,
        "vs_nominal": bps / spec,
        "fit_residual": fit.rel_residual,
        "fit_dispersion": fit.dispersion,
        "dispatch_ms": fit.intercept_s * 1e3,
        "rejected_samples": rejected,
    }


def worker_main() -> int:
    try:
        res = _measure_worker()
    except Exception as exc:
        # surface as a structured worker error, not a bare traceback
        # with no WORKER_RESULT line
        import traceback
        traceback.print_exc()
        res = {"error": f"worker exception: {type(exc).__name__}: {exc}"}
    print("WORKER_RESULT " + json.dumps(res))
    return 0 if "error" not in res else 1


def _run_worker(idx: int, timeout_s: float = 5400.0) -> dict:
    env = dict(os.environ)
    cmd = [sys.executable, os.path.abspath(__file__), "--worker"]
    if os.environ.get("LFS_BENCH_WORKER_CMD"):
        # test hook: substitute the worker process (e.g. `sleep 9999` to
        # exercise the watchdog, or a script printing a canned
        # WORKER_RESULT line to exercise the agreement logic)
        import shlex
        cmd = shlex.split(os.environ["LFS_BENCH_WORKER_CMD"])
    try:
        with subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env=env) as p:
            _CURRENT_WORKER.append(p)   # so the deadline watchdog can
            #                             kill it instead of orphaning it
            try:
                out, err = p.communicate(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                if err:
                    sys.stderr.write(err)
                return {"error": f"worker {idx} timed out after "
                                 f"{timeout_s:.0f}s"}
            finally:
                _CURRENT_WORKER.clear()
        proc = subprocess.CompletedProcess(cmd, p.returncode, out, err)
    except OSError as e:
        return {"error": f"worker {idx} failed to launch: {e}"}
    sys.stderr.write(proc.stderr)
    for line in proc.stdout.splitlines():
        if line.startswith("WORKER_RESULT "):
            return json.loads(line[len("WORKER_RESULT "):])
    return {"error": f"worker {idx} produced no result "
                     f"(rc={proc.returncode})"}


def _final_line(slow: dict, spread, agreement: str) -> dict:
    return {
        "metric": "flagstat_words_per_sec",
        "value": round(slow["words_per_s"], 1),
        "unit": "words/s",
        "vs_baseline": round(slow["vs_roofline"], 4),
        "kernel_ms": round(slow["kernel_ms"], 4),
        "gbytes_per_s": round(slow["bytes_per_s"] / 1e9, 1),
        "roofline_gbs": round(slow["roofline_gbs"], 1),
        "roofline_kind": slow.get("roofline_kind", "?"),
        "defended_roofline_gbs": round(slow["defended_roofline_gbs"], 1)
        if "defended_roofline_gbs" in slow else None,
        "vs_defended": (round(slow["vs_defended"], 4)
                        if "vs_defended" in slow else None),
        "mode": slow.get("mode", "full_parity"),
        "alt": ({
            "mode": slow["alt"]["mode"],
            "kernel_ms": round(slow["alt"]["kernel_ms"], 4),
            "gbytes_per_s": round(slow["alt"]["bytes_per_s"] / 1e9, 1),
            "vs_roofline": round(slow["alt"]["vs_roofline"], 4),
            "vs_defended": (round(slow["alt"]["vs_defended"], 4)
                            if "vs_defended" in slow["alt"] else None),
        } if slow.get("alt") else None),
        "cross_process_spread_pct": (None if spread is None
                                     else round(spread, 2)),
        "fit_residual": round(slow["fit_residual"], 4),
        "backend": slow["backend"],
        "device_kind": slow.get("device_kind"),
        "agreement": agreement,
    }


def assemble_final(results: list[dict], agree_pct: float = AGREE_PCT):
    """Pick the printed result from valid worker results.

    Preferred: the slower member of the first cross-process pair agreeing
    within agree_pct (reproduction rule). Degraded: if workers are
    exhausted without an agreeing pair but >= 1 result passed every
    in-process plausibility gate (oracle bit-exactness, fit dispersion,
    nominal-bandwidth cap), report the MEDIAN such result labeled
    agreement="unconfirmed", with every worker's value published —
    robust to one outlier in either direction. Returns
    (line_dict, exit_code); line_dict is None when there is nothing
    plausible to report.
    """
    from libflagstats_tpu.bench.harness import agreeing_pair

    pair = agreeing_pair(results, agree_pct, key=lambda s: s["words_per_s"])
    if pair is not None:
        ra, rb = results[pair[0]], results[pair[1]]
        va, vb = ra["words_per_s"], rb["words_per_s"]
        slow = ra if va <= vb else rb
        return _final_line(slow, 200.0 * abs(va - vb) / (va + vb),
                           "cross_process"), 0
    if results:
        ranked = sorted(results, key=lambda s: s["words_per_s"])
        med = ranked[(len(ranked) - 1) // 2]   # lower median: conservative
        line = _final_line(med, None, "unconfirmed")
        line["n_valid_workers"] = len(results)
        line["worker_gbytes_per_s"] = [
            round(s["bytes_per_s"] / 1e9, 1) for s in results
        ]
        return line, 0
    return None, 1


def _zero_artifact_line(why: str) -> dict:
    return {
        "metric": "flagstat_words_per_sec", "value": 0.0,
        "unit": "words/s", "vs_baseline": 0.0, "error": why,
    }


def _fallback_line(results: list[dict], why: str) -> tuple[dict, int]:
    """Best structured line available when the run cannot finish
    normally: results-so-far (labeled unconfirmed), else the
    zero-artifact error schema."""
    line, rc = assemble_final(results)
    if line is not None:
        line["note"] = why
        return line, rc
    return _zero_artifact_line(why), 1


def _emit(line: dict, rc: int) -> int:
    """Print the ONE final JSON line exactly once (main thread and
    watchdog race for it; first wins)."""
    with _EMIT_LOCK:
        if not _EMITTED.is_set():
            _EMITTED.set()
            print(json.dumps(line), flush=True)
    return rc


def _watchdog_main(t_start_real: float) -> None:
    """Daemon thread: at DEADLINE_S of REAL wall time, print the best
    available line and hard-exit. A thread (not a main-loop check)
    because the main thread can be stuck waiting on a hung worker."""
    while True:
        left = DEADLINE_S - (_REAL_MONOTONIC() - t_start_real)
        if left <= 0:
            break
        if _EMITTED.wait(timeout=min(left, 5.0)):
            return
    if _EMITTED.is_set():
        return
    line, rc = _fallback_line(
        list(_RESULTS),
        f"deadline LFS_BENCH_DEADLINE_S={DEADLINE_S:.0f}s reached")
    print("[bench] watchdog: deadline reached, emitting fallback line",
          file=sys.stderr)
    _emit(line, rc)
    for p in list(_CURRENT_WORKER):   # don't orphan a worker on the card
        try:
            p.kill()
        except OSError:
            pass
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)


def main() -> int:
    _EMITTED.clear()
    _RESULTS.clear()
    results = _RESULTS
    t_start = time.monotonic()
    threading.Thread(target=_watchdog_main, args=(_REAL_MONOTONIC(),),
                     daemon=True).start()
    for i in range(MAX_WORKERS):
        elapsed = time.monotonic() - t_start
        if i and elapsed > WALL_BUDGET_S:
            print(f"[bench] wall budget ({WALL_BUDGET_S:.0f}s) exhausted "
                  f"after {i} workers", file=sys.stderr)
            break
        # the first worker compiles cold and gets up to 5400 s; later
        # workers reuse the persistent compile cache and only get the
        # remaining budget (600 s floor). Everything is clamped to the
        # deadline so the subprocess dies (and its result line is
        # parsed) before the watchdog would fire blind.
        t_worker = max(600.0, (5400.0 if i == 0 else WALL_BUDGET_S)
                       - elapsed)
        t_worker = max(30.0, min(t_worker, DEADLINE_S - elapsed - 30.0))
        r = _run_worker(i, timeout_s=t_worker)
        if "error" in r:
            print(f"[bench] worker {i}: {r['error']}", file=sys.stderr)
            continue
        results.append(r)
        line, rc = assemble_final(results)
        if line is not None and line["agreement"] == "cross_process":
            return _emit(line, rc)
    # workers exhausted without an agreeing pair
    line, rc = assemble_final(results)
    if line is None:
        return _emit(*_fallback_line(
            results,
            f"no worker produced a plausible sample ({MAX_WORKERS} "
            "attempts)"))
    print(f"[bench] WARNING: no two of {len(results)} workers agreed "
          f"within {AGREE_PCT}%; printing the median gate-passing "
          f"result, labeled unconfirmed", file=sys.stderr)
    return _emit(line, rc)


if __name__ == "__main__":
    if "--worker" in sys.argv:
        sys.exit(worker_main())
    sys.exit(main())
