"""Genuine two-process jax.distributed run (SURVEY §5.8).

Every other multi-chip test in this suite uses a single process with a
virtual 8-device CPU mesh; this one spawns TWO OS processes that
rendezvous through jax.distributed.initialize (local coordinator), each
scores its contiguous shard of the fixture chains (scoreChain
-numShards/-shard semantics), and the outputs are merged to process 0
over the collective path (host0_merge_text process_allgather).  The
merged file must be byte-identical to a single-process run.

Skipped cleanly if the runtime forbids a local two-process rendezvous
(some sandboxes block the coordinator socket).
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import os, sys
import jax
jax.distributed.initialize(coordinator_address=sys.argv[1],
                           num_processes=2, process_id=int(sys.argv[2]))
pid = jax.process_index()
if jax.process_count() != 2:
    # coordination-service hiccup (observed sporadically in this sandbox:
    # initialize returns but the job state watch is CANCELLED and the
    # process sees only itself) - report transient, parent retries
    print("WORKER_TRANSIENT process_count", jax.process_count(), flush=True)
    sys.exit(42)
from genomealignmenttools_tpu.engines.score_chain import score_chain_file
from genomealignmenttools_tpu.parallel.distributed import host0_merge_text

fixtures = sys.argv[3]
out_path = sys.argv[4]
shard_path = out_path + f".shard{pid}"
score_chain_file(os.path.join(fixtures, "synthetic.chain"),
                 os.path.join(fixtures, "target.2bit"),
                 os.path.join(fixtures, "query.2bit"),
                 shard_path, linear_gap="loose", num_shards=2, shard=pid)
merged = host0_merge_text(open(shard_path).read(), max_bytes=1 << 22)
if pid == 0:
    with open(out_path, "w") as f:
        f.write(merged)
print("WORKER_OK", pid)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rendezvous_once(fixtures_dir, out_path):
    """One two-worker attempt; returns None on success, else a transient
    error string (connect/timeout) - anything else raises."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # one device per process
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, coord, str(i), fixtures_dir,
         out_path], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            return "rendezvous timed out"
    for i, (out, err) in enumerate(outs):
        if procs[i].returncode == 42 or "WORKER_TRANSIENT" in out:
            return f"transient: {out.strip().splitlines()[-1][:120]}"
        if procs[i].returncode != 0:
            if ("UNAVAILABLE" in err or "permission" in err.lower()
                    or "DEADLINE_EXCEEDED" in err
                    or "failed to connect" in err.lower()):
                return err.splitlines()[-1][:160]
            raise AssertionError(f"worker {i} failed:\n{err[-2000:]}")
        assert f"WORKER_OK {i}" in out
    return None


def test_two_process_sharded_scorechain(fixtures_dir, golden_dir, tmp_path):
    out_path = str(tmp_path / "merged.chain")
    # the local coordinator bind/connect can race under CPU contention:
    # retry transient connect failures on fresh ports before skipping
    last = None
    for _attempt in range(3):
        last = _rendezvous_once(fixtures_dir, out_path)
        if last is None:
            break
    else:
        pytest.skip(f"runtime forbids local rendezvous: {last}")

    # single-process oracle
    from genomealignmenttools_tpu.engines.score_chain import score_chain_file
    oracle = str(tmp_path / "oracle.chain")
    score_chain_file(os.path.join(fixtures_dir, "synthetic.chain"),
                     os.path.join(fixtures_dir, "target.2bit"),
                     os.path.join(fixtures_dir, "query.2bit"),
                     oracle, linear_gap="loose")
    assert open(out_path).read() == open(oracle).read()
