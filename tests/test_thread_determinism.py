"""Thread-count determinism of the native runtime.

The reference is single-threaded C; this framework introduced real
concurrency (threaded chain codec parse/serialize, per-chrom parallel net
sweep, threaded net writer, threaded pair pack - native/chaincodec.cpp,
netsweep.cpp, netwrite.cpp, pairpack.cpp).  A data race there would show
up as silent byte-level corruption, so every threaded path must produce
byte-identical output at ANY thread count.  GAT_THREADS pins the worker
count (native/gat_threads.h; read once per process, hence subprocesses).

The chr1-lite workload (~33 Mb, 3400 chains, >4096-chain / >1 MB
thresholds where the native code actually spawns workers) is driven
through the real CLI at GAT_THREADS=1 (sequential oracle) vs
GAT_THREADS=8 (oversubscribed: more workers than cores maximizes
interleaving) and outputs are byte-compared.

TSAN evidence is separate: tools/tsan_check.sh builds the native library
with -fsanitize=thread and replays these workloads under it (slow; see
PARITY.md for the last recorded clean run).
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LITE_DIR = os.environ.get("GAT_LITE_DIR", "/tmp/gat_lite") + "/cleaner"


@pytest.fixture(scope="session")
def lite_workload():
    from genomealignmenttools_tpu.utils.bench_workload import (
        build_cleaner_workload)
    return build_cleaner_workload(LITE_DIR, n_scenarios=200, n_bulk=3000)


def _run_cli(args, threads, cwd):
    env = dict(os.environ)
    env["GAT_THREADS"] = str(threads)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    subprocess.run([sys.executable, "-m",
                    "genomealignmenttools_tpu.cli.main", *args],
                   env=env, check=True, capture_output=True, cwd=cwd)


def test_chaincleaner_thread_determinism(lite_workload, tmp_path):
    """cleaner end-to-end (codec parse, sweep, fused breaks, prescore,
    serialize) at 1 vs 8 threads: byte-identical."""
    m = lite_workload
    outs = {}
    for n in (1, 8):
        d = tmp_path / f"t{n}"
        d.mkdir()
        _run_cli(["chainCleaner", m["chain"], m["t2bit"], m["q2bit"],
                  str(d / "out.chain"), str(d / "out.bed"),
                  "-tSizes=" + m["t_sizes"], "-qSizes=" + m["q_sizes"],
                  "-linearGap=loose"], n, str(d))
        outs[n] = ((d / "out.chain").read_bytes(),
                   (d / "out.bed").read_bytes())
    assert outs[1] == outs[8]


def test_chainnet_rescore_thread_determinism(lite_workload, tmp_path):
    """chainNet -rescore (sweep + writer + batched rescore) at 1 vs 8
    threads: byte-identical."""
    m = lite_workload
    outs = {}
    for n in (1, 8):
        d = tmp_path / f"t{n}"
        d.mkdir()
        _run_cli(["chainNet", "-rescore", "-linearGap=loose",
                  "-tNibDir=" + m["t2bit"], "-qNibDir=" + m["q2bit"],
                  m["chain"], m["t_sizes"], m["q_sizes"],
                  str(d / "t.net"), str(d / "q.net")], n, str(d))
        outs[n] = ((d / "t.net").read_bytes(), (d / "q.net").read_bytes())
    assert outs[1] == outs[8]


def test_scorechain_thread_determinism(lite_workload, tmp_path):
    """scoreChain (codec + pair pack + score + serialize) at 1 vs 8
    threads: byte-identical."""
    m = lite_workload
    outs = {}
    for n in (1, 8):
        d = tmp_path / f"t{n}"
        d.mkdir()
        _run_cli(["scoreChain", m["chain"], m["t2bit"], m["q2bit"],
                  str(d / "out.chain"), "-linearGap=loose"], n, str(d))
        outs[n] = (d / "out.chain").read_bytes()
    assert outs[1] == outs[8]


def test_repeatfiller_thread_determinism(tmp_path):
    """RepeatFiller's threaded gap stages (native/hspscan.cpp window
    scan, native/bandext.cpp band batch) must be byte-identical at any
    thread count - both preserve the caller's ordering by construction
    (windows spliced back in submission order, band results indexed by
    problem)."""
    from genomealignmenttools_tpu.utils.bench_workload import (
        build_repeatfiller_workload)
    m = build_repeatfiller_workload(
        os.environ.get("GAT_LITE_DIR", "/tmp/gat_lite") + "/repeatfiller",
        n_gaps=120)
    from conftest import hermetic_cpu_env
    outs = {}
    for threads in (1, 8):
        out = str(tmp_path / f"rf_{threads}.chain")
        env = hermetic_cpu_env()
        env["GAT_THREADS"] = str(threads)
        subprocess.run([sys.executable, "-m",
                        "genomealignmenttools_tpu.cli.main", "RepeatFiller",
                        "-c", m["chain"], "-T2", m["t2bit"],
                        "-Q2", m["q2bit"], "-o", out],
                       env=env, check=True, capture_output=True,
                       cwd=str(tmp_path), timeout=300)
        outs[threads] = open(out).read()
    assert outs[1] == outs[8]
    assert outs[1].count("chain ") >= 1
