#!/usr/bin/env python
"""Smoke test of the chain-rescoring path on one GPU.

    python chip_smoke.py

One process, which never falls back to the CPU.  Phases, in order:

1. device: JAX's default backend is the GPU and the native library loads;
   prints the card's name and power limit, its device kind, the JAX
   version and the compile-cache directory.
2. goldens: scoreChain -linearGap=loose, chainNet -rescore and
   chainCleaner through the `gat` CLI on tests/fixtures, under every
   rescore mode and tile/combine variant a knob can select; every output
   must equal the reference C tools' golden byte for byte.
3. chr1 scale: the same three tools on the chr1-scale chainCleaner
   workload (utils/bench_workload.build_cleaner_workload, cached under
   GAT_BENCH_DIR) under GAT_RESCORE=pair, xla and hostnative - the last is
   the plain host reference, threaded C++ with no device code; all outputs
   must be byte-identical.  Prints cold and warm wall time of each.
4. resident re-scoring: PairChainScorer.score over that chain set with the
   staged device combine, equal to the host combine for every chain;
   times warm passes, the chunk-sum and the combine alone.

Any failure raises, so the exit code is non-zero.  The last line of
standard output is one JSON object naming the device.
"""

from __future__ import annotations

import contextlib
import filecmp
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "tests", "fixtures")
GOLDEN = os.path.join(HERE, "tests", "golden")

# (GAT_RESCORE, extra env) for the fixture goldens: both device modes,
# plus each tile layout and the forced device combine of the pair mode
GOLDEN_VARIANTS = (
    ("pair", {}),
    ("xla", {}),
    ("pair", {"GAT_PAIR_TILES": "score4"}),
    ("pair", {"GAT_PAIR_TILES": "code"}),
    ("pair", {"GAT_COMBINE": "device"}),
)
CHR1_MODES = ("pair", "xla", "hostnative")
N_PASS = 10


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def _env(**kv):
    """Set environment variables for the block, then restore them."""
    saved = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_gat(argv: list[str]) -> float:
    """Run one `gat` command in-process; returns its wall time."""
    from genomealignmenttools_tpu.cli.main import main as gat_main
    t0 = time.perf_counter()
    rc = gat_main(argv + ["-verbose=0"])
    dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"gat {argv[0]} exited {rc}")
    return dt


def tool_runs(inp: dict, out_dir: str, tag: str):
    """[(tool, argv, outputs)] for scoreChain -linearGap=loose, chainNet
    -rescore and chainCleaner over one input set."""
    def out(name):
        return os.path.join(out_dir, f"{tag}.{name}")
    return [
        ("scoreChain",
         ["scoreChain", inp["chain"], inp["t2bit"], inp["q2bit"],
          out("scored.chain"), "-linearGap=loose"],
         [out("scored.chain")]),
        ("chainNet -rescore",
         ["chainNet", inp["sorted_chain"], inp["t_sizes"], inp["q_sizes"],
          out("t.net"), out("q.net"), "-rescore",
          "-tNibDir=" + inp["t2bit"], "-qNibDir=" + inp["q2bit"],
          "-linearGap=loose"],
         [out("t.net"), out("q.net")]),
        ("chainCleaner",
         ["chainCleaner", inp["sorted_chain"], inp["t2bit"], inp["q2bit"],
          out("clean.chain"), out("clean.bed"), "-tSizes=" + inp["t_sizes"],
          "-qSizes=" + inp["q_sizes"], "-linearGap=loose"],
         [out("clean.chain"), out("clean.bed")]),
    ]


def _same(a: str, b: str) -> None:
    if not filecmp.cmp(a, b, shallow=False):
        raise AssertionError(f"{a} differs from {b}")


def golden_phase(fixtures_dir: str, golden_dir: str, work_dir: str,
                 variants=GOLDEN_VARIANTS) -> dict:
    """Fixture-scale goldens: every variant's outputs must equal the
    reference C tools' outputs.  Returns {variant: {tool: seconds}}."""
    inp = {
        "chain": os.path.join(fixtures_dir, "synthetic.chain"),
        "sorted_chain": os.path.join(fixtures_dir,
                                     "synthetic.scored.sorted.chain"),
        "t2bit": os.path.join(fixtures_dir, "target.2bit"),
        "q2bit": os.path.join(fixtures_dir, "query.2bit"),
        "t_sizes": os.path.join(fixtures_dir, "target.chrom.sizes"),
        "q_sizes": os.path.join(fixtures_dir, "query.chrom.sizes"),
    }
    golden = {
        "scoreChain": ["scoreChain.loose.chain"],
        "chainNet -rescore": ["chainNetRescore.target.net",
                              "chainNetRescore.query.net"],
        "chainCleaner": ["chainCleaner.out.chain",
                         "chainCleaner.removedSuspects.bed"],
    }
    os.makedirs(work_dir, exist_ok=True)
    times = {}
    for mode, extra in variants:
        name = "+".join([mode] + [f"{k}={v}" for k, v in extra.items()])
        tag = name.replace("=", "_")
        times[name] = {}
        with _env(GAT_RESCORE=mode, **extra):
            for tool, argv, outs in tool_runs(inp, work_dir, tag):
                times[name][tool] = run_gat(argv)
                for got, want in zip(outs, golden[tool]):
                    _same(got, os.path.join(golden_dir, want))
        log(f"goldens {name}: all outputs equal the reference goldens "
            + json.dumps({k: round(v, 3) for k, v in times[name].items()}))
    return times


def chr1_phase(workload: dict, work_dir: str, modes=CHR1_MODES) -> dict:
    """Each tool under each mode, cold then warm; outputs byte-identical
    across modes.  Returns {tool: {mode: (cold_s, warm_s)}}."""
    inp = dict(workload, sorted_chain=workload["chain"])
    os.makedirs(work_dir, exist_ok=True)
    times: dict = {}
    outs_of: dict = {}
    for mode in modes:
        with _env(GAT_RESCORE=mode):
            for tool, argv, outs in tool_runs(inp, work_dir, mode):
                cold = run_gat(argv)
                warm = run_gat(argv)
                times.setdefault(tool, {})[mode] = (cold, warm)
                outs_of.setdefault(tool, []).append(outs)
                log(f"chr1 {tool} {mode}: cold {cold:.3f} s, "
                    f"warm {warm:.3f} s")
    for tool, per_mode in outs_of.items():
        for outs in per_mode[1:]:
            for got, ref in zip(outs, per_mode[0]):
                _same(got, ref)
        log(f"chr1 {tool}: byte-identical under {', '.join(modes)}")
    return times


def resident_phase(workload: dict, n_pass: int = N_PASS) -> dict:
    """PairChainScorer.score with the staged device combine vs the host
    combine and the host reference, then timed warm passes."""
    import jax
    import numpy as np

    from genomealignmenttools_tpu.device.genome import Genome
    from genomealignmenttools_tpu.formats.chain import read_chains
    from genomealignmenttools_tpu.formats.gapcalc import gap_calc_from_file
    from genomealignmenttools_tpu.formats.scorematrix import (
        score_scheme_default)
    from genomealignmenttools_tpu.native import get_lib
    from genomealignmenttools_tpu.ops.pair_rescore import PairChainScorer
    from genomealignmenttools_tpu.ops.rescore import (DeviceChainScorer,
                                                      _native_combine)

    scheme, gc = score_scheme_default(), gap_calc_from_file("loose")
    tg, qg = Genome(workload["t2bit"]), Genome(workload["q2bit"])
    chains = read_chains(workload["chain"])
    scorer = DeviceChainScorer(scheme, gc, tg, qg, mode="pair")
    jobs, order = scorer._grouped(chains)
    nblocks = [chains[i].n_blocks for i in order]
    pcs = PairChainScorer(scorer._dev, gc)

    t0 = time.perf_counter()
    dev = pcs.score(jobs, nblocks)
    first_s = time.perf_counter() - t0

    cs, c_block, _ = scorer._dev.chunk_scores_multi(jobs)
    chain_off = np.zeros(len(nblocks) + 1, np.int64)
    np.cumsum(nblocks, out=chain_off[1:])
    host = _native_combine(get_lib(), cs, c_block,
                           scorer._all_blocks_memo(jobs), chain_off, gc)
    want = [(float(r[0]), float(r[1]), int(r[2])) for r in host]
    if dev != want:
        bad = sum(a != b for a, b in zip(dev, want))
        raise AssertionError(f"device combine != host combine "
                             f"for {bad} of {len(want)} chains")
    ref = DeviceChainScorer(scheme, gc, tg, qg, mode="hostnative")
    ref_out = ref.score_chains([chains[i] for i in order])
    if dev != ref_out:
        raise AssertionError("device combine != hostnative reference")
    log(f"resident: device combine == host combine == hostnative for "
        f"{len(want)} chains")

    def timed(fn):
        fn().block_until_ready()  # compile
        out = []
        for _ in range(n_pass):
            t0 = time.perf_counter()
            fn().block_until_ready()
            out.append(time.perf_counter() - t0)
        return sorted(out)

    full = timed(lambda: pcs.score_async(jobs, nblocks))
    sums = timed(lambda: pcs.chunk_sums_async(jobs, nblocks))
    s = pcs.chunk_sums_async(jobs, nblocks)
    comb = timed(lambda: pcs.combine_async(s, jobs, nblocks))
    stats = jax.devices()[0].memory_stats() or {}
    res = {
        "n_chains": len(want),
        "first_pass_s": first_s,
        "pass_ms": [1e3 * t for t in full],
        "chunk_sum_ms": [1e3 * t for t in sums],
        "combine_ms": [1e3 * t for t in comb],
        "resident_hbm_bytes": pcs.resident_hbm_bytes(jobs, nblocks),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
    }
    med = n_pass // 2
    log(f"resident: {n_pass} warm passes, median {res['pass_ms'][med]:.3f}"
        f" ms/pass (chunk-sum {res['chunk_sum_ms'][med]:.3f} ms, combine "
        f"{res['combine_ms'][med]:.3f} ms); resident_hbm_bytes "
        f"{res['resident_hbm_bytes']}; peak_bytes_in_use "
        f"{res['peak_bytes_in_use']}")
    return res


def device_phase() -> dict:
    """The GPU backend, the native library, the card's name and power
    limit; raises on anything else."""
    import jax

    from genomealignmenttools_tpu.native import get_lib
    from genomealignmenttools_tpu.ops.rescore import _init_jax

    _init_jax()
    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(f"JAX backend is {backend!r}, not the GPU")
    if get_lib() is None:
        raise RuntimeError("native library did not load")
    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(card)
    log(f"device_kind {dev.device_kind}; jax {jax.__version__}; compile "
        f"cache {jax.config.jax_compilation_cache_dir}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card}


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "genomealignmenttools_tpu")):
        raise SystemExit("chip_smoke.py must run from a checkout of the "
                         "repository")
    sys.path.insert(0, HERE)
    from genomealignmenttools_tpu.utils.bench_workload import (
        bench_dir, build_cleaner_workload)

    phase_s = {}
    t0 = time.perf_counter()
    device = device_phase()
    phase_s["device"] = time.perf_counter() - t0

    work = os.path.join(bench_dir(), "smoke")
    t0 = time.perf_counter()
    golden_phase(FIXTURES, GOLDEN, os.path.join(work, "golden"))
    phase_s["goldens"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    workload = build_cleaner_workload(os.path.join(bench_dir(), "cleaner"))
    phase_s["workload_build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    chr1 = chr1_phase(workload, os.path.join(work, "chr1"))
    phase_s["chr1"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    resident = resident_phase(workload)
    phase_s["resident"] = time.perf_counter() - t0

    log("card " + device["card"])
    log("chr1 times (cold_s, warm_s): " + json.dumps(chr1))
    log("resident: " + json.dumps(resident))
    log("phase wall s: " + json.dumps(phase_s))
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
