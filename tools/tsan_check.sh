#!/bin/sh -e
# ThreadSanitizer smoke run for the native runtime (native/*.cpp).
#
# Builds libgatnative with -fsanitize=thread into a scratch dir and
# replays the threaded hot paths (chain codec parse/serialize, per-chrom
# net sweep, net writer, fused breaks, pair pack) on the chr1-lite
# workload with GAT_THREADS=8, running python under the TSAN runtime
# (LD_PRELOAD).  Any race report makes the run exit non-zero.
#
# Usage: tools/tsan_check.sh   (takes ~2-4 min; result recorded in
# PARITY.md).  tests/test_thread_determinism.py is the fast byte-parity
# companion that runs in the default suite.

REPO=$(cd "$(dirname "$0")/.." && pwd)
SCRATCH=${TMPDIR:-/tmp}/gat_tsan
mkdir -p "$SCRATCH"

echo "== building TSAN libgatnative =="
g++ -O1 -g -fPIC -shared -std=c++17 -pthread -fsanitize=thread \
    -o "$SCRATCH/libgatnative.so" "$REPO"/genomealignmenttools_tpu/native/*.cpp

TSAN_RT=$(g++ -print-file-name=libtsan.so)
echo "== replaying threaded paths under TSAN (GAT_THREADS=8) =="
LD_PRELOAD="$TSAN_RT" \
TSAN_OPTIONS="halt_on_error=0 exitcode=66" \
GAT_THREADS=8 \
GAT_NATIVE_SO="$SCRATCH/libgatnative.so" \
JAX_PLATFORMS=cpu \
PYTHONPATH="$REPO" \
python - <<'EOF'
import os, sys, tempfile
from genomealignmenttools_tpu.utils.bench_workload import (
    build_cleaner_workload)
from genomealignmenttools_tpu import native
assert native.get_lib() is not None, "TSAN native build failed to load"
m = build_cleaner_workload(
    os.environ.get("GAT_LITE_DIR", "/tmp/gat_lite") + "/cleaner",
    n_scenarios=200, n_bulk=3000)
d = tempfile.mkdtemp(prefix="gat_tsan_run_")
from genomealignmenttools_tpu.engines.chain_cleaner import clean_chains
from genomealignmenttools_tpu.engines.chain_net import chain_net
from genomealignmenttools_tpu.engines.score_chain import score_chain_file
from genomealignmenttools_tpu.utils.verbose import set_verbosity
set_verbosity(0)
clean_chains(m["chain"], m["t2bit"], m["q2bit"],
             os.path.join(d, "out.chain"), os.path.join(d, "out.bed"),
             t_sizes=m["t_sizes"], q_sizes=m["q_sizes"],
             linear_gap="loose")
print("chainCleaner under TSAN: done")
with open(os.path.join(d, "t.net"), "w") as t_out, \
        open(os.path.join(d, "q.net"), "w") as q_out:
    chain_net(m["chain"], m["t_sizes"], m["q_sizes"], t_out, q_out,
              rescore=True, t_2bit=m["t2bit"], q_2bit=m["q2bit"],
              linear_gap="loose")
print("chainNet -rescore under TSAN: done")
score_chain_file(m["chain"], m["t2bit"], m["q2bit"],
                 os.path.join(d, "scored.chain"), linear_gap="loose")
print("scoreChain under TSAN: done")
# gap engines: threaded HSP window scan (hspscan.cpp) + threaded band
# batch (bandext.cpp) through the full RepeatFiller path
from genomealignmenttools_tpu.utils.bench_workload import (
    build_repeatfiller_workload)
rf = build_repeatfiller_workload(
    os.environ.get("GAT_LITE_DIR", "/tmp/gat_lite") + "/repeatfiller",
    n_gaps=120)
from genomealignmenttools_tpu.engines.repeat_filler import repeat_filler
repeat_filler(rf["chain"], rf["t2bit"], rf["q2bit"],
              os.path.join(d, "rf.chain"))
print("RepeatFiller (hspscan + bandext) under TSAN: done")
EOF
echo "== TSAN clean =="
