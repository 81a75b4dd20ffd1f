"""Drop-in command surface for the toolkit.

One multiplexed entry point (`python -m genomealignmenttools_tpu.cli.main` or
the `gat` console script) whose subcommands mirror the reference binaries:
scoreChain, chainNet, chainCleaner, chainSort, netFilterNonNested,
repeatFiller, ...  Flags follow the reference's single-dash -name=value
convention so existing pipelines can switch without edits.
"""

from __future__ import annotations

import sys


def _parse_kent_args(argv: list[str]) -> tuple[list[str], dict[str, str]]:
    """Parse kent-style args: positional plus -flag / -flag=value."""
    pos: list[str] = []
    opts: dict[str, str] = {}
    for a in argv:
        if a.startswith("-") and len(a) > 1 and not a[1].isdigit():
            body = a.lstrip("-")
            if "=" in body:
                k, v = body.split("=", 1)
                opts[k] = v
            else:
                opts[body] = ""
        else:
            pos.append(a)
    return pos, opts


def cmd_score_chain(argv: list[str]) -> int:
    from ..engines.score_chain import score_chain_file

    pos, opts = _parse_kent_args(argv)
    if len(pos) != 4:
        print("usage: scoreChain in.chain target.2bit query.2bit out.chain "
              "-linearGap=loose|medium|file [-scoreScheme=file] [-doLocalScore] "
              "[-forceLocalScore] [-returnOnlyScore] [-returnOnlyScoreAndCoords]",
              file=sys.stderr)
        return 255
    score_chain_file(
        pos[0], pos[1], pos[2], pos[3],
        linear_gap=opts.get("linearGap", ""),
        score_scheme=opts.get("scoreScheme"),
        do_local_score="doLocalScore" in opts,
        force_local_score="forceLocalScore" in opts,
        return_only_score="returnOnlyScore" in opts,
        return_only_score_and_coords="returnOnlyScoreAndCoords" in opts,
        num_shards=int(opts.get("numShards", 1)),
        shard=int(opts.get("shard", 0)),
    )
    return 0


def cmd_chain_sort(argv: list[str]) -> int:
    from ..formats.chain import (read_chains, sort_chains_by_query,
                                 sort_chains_by_score, sort_chains_by_target,
                                 write_chains)

    pos, opts = _parse_kent_args(argv)
    if len(pos) != 2:
        print("usage: chainSort in.chain out.chain [-target|-query] "
              "[-index=out.tab]", file=sys.stderr)
        return 255
    meta_lines: list[str] = []
    chains = read_chains(pos[0], meta_out=meta_lines.append)
    if "target" in opts:
        chains = sort_chains_by_target(chains)
    elif "query" in opts:
        chains = sort_chains_by_query(chains)
    else:
        chains = sort_chains_by_score(chains)
    # meta lines are crossed during the read, before any chain is written
    # (chainSort.c:58), so they land at the top of the sorted output
    out = sys.stdout if pos[1] == "stdout" else open(pos[1], "w")
    index = open(opts["index"], "w") if opts.get("index") else None
    try:
        offset = 0
        for line in meta_lines:
            out.write(line + "\n")
            offset += len(line) + 1
        if index is None:
            write_chains(chains, out)
        else:
            # two-column index: hex output offset + key, on key change
            # (chainSort.c:78-110; sentinels lastScore=-1, names="")
            last_score, last_t, last_q = -1.0, "", ""
            for c in chains:
                if "target" in opts:
                    if c.t_name != last_t:
                        last_t = c.t_name
                        index.write(f"{offset:x}\t{c.t_name}\n")
                elif "query" in opts:
                    if c.q_name != last_q:
                        last_q = c.q_name
                        index.write(f"{offset:x}\t{c.q_name}\n")
                else:
                    if c.score != last_score:
                        last_score = c.score
                        index.write(f"{offset:x}\t{c.score:.0f}\n")
                text = c.to_text()
                out.write(text)
                offset += len(text)
    finally:
        if index is not None:
            index.close()
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_chain_net(argv: list[str]) -> int:
    from ..engines.chain_net import chain_net_main
    return chain_net_main(argv)


def cmd_chain_cleaner(argv: list[str]) -> int:
    from ..engines.chain_cleaner import chain_cleaner_main
    return chain_cleaner_main(argv)


def cmd_axt_chain(argv: list[str]) -> int:
    from ..engines.axt_chain import axt_chain_main
    return axt_chain_main(argv)


def cmd_net_filter_non_nested(argv: list[str]) -> int:
    from ..engines.net_filter_nonnested import net_filter_non_nested_main
    return net_filter_non_nested_main(argv)


def cmd_repeat_filler(argv: list[str]) -> int:
    from ..engines.repeat_filler import repeat_filler_main
    return repeat_filler_main(argv)




def cmd_chain_pre_net(argv):
    from ..engines.chain_tools import chain_pre_net
    pos, opts = _parse_kent_args(argv)
    if len(pos) != 4:
        print("usage: chainPreNet in.chain target.sizes query.sizes out.chain",
              file=sys.stderr)
        return 255
    chain_pre_net(pos[0], pos[1], pos[2],
                  sys.stdout if pos[3] == "stdout" else pos[3],
                  pad=int(opts.get("pad", 1)), incl_hap="inclHap" in opts,
                  dots=int(opts.get("dots", 0)))
    return 0


def cmd_chain_stitch_id(argv):
    from ..engines.chain_tools import chain_stitch_id
    pos, _ = _parse_kent_args(argv)
    if len(pos) != 2:
        print("usage: chainStitchId in.chain out.chain", file=sys.stderr)
        return 255
    chain_stitch_id(pos[0], sys.stdout if pos[1] == "stdout" else pos[1])
    return 0


def cmd_chain_filter(argv):
    from ..engines.chain_tools import chain_filter, BIGNUM
    pos, o = _parse_kent_args(argv)
    if not pos:
        print("usage: chainFilter file(s) [options] > out.chain", file=sys.stderr)
        return 255
    chain_filter(
        pos, sys.stdout,
        q=o.get("q"), not_q=o.get("notQ"), t=o.get("t"), not_t=o.get("notT"),
        id_=int(o["id"]) if "id" in o else None,
        id_list=o.get("idList"), id_file=o.get("idFile"),
        id_exclude_file=o.get("idExcludeFile"),
        min_score=float(o.get("minScore", -BIGNUM)),
        max_score=float(o.get("maxScore", 1.0e20)),
        q_start_min=int(o.get("qStartMin", -BIGNUM)),
        q_start_max=int(o.get("qStartMax", BIGNUM)),
        q_end_min=int(o.get("qEndMin", -BIGNUM)),
        q_end_max=int(o.get("qEndMax", BIGNUM)),
        t_start_min=int(o.get("tStartMin", -BIGNUM)),
        t_start_max=int(o.get("tStartMax", BIGNUM)),
        t_end_min=int(o.get("tEndMin", -BIGNUM)),
        t_end_max=int(o.get("tEndMax", BIGNUM)),
        q_overlap_start=int(o.get("qOverlapStart", -BIGNUM)),
        q_overlap_end=int(o.get("qOverlapEnd", BIGNUM)),
        t_overlap_start=int(o.get("tOverlapStart", -BIGNUM)),
        t_overlap_end=int(o.get("tOverlapEnd", BIGNUM)),
        strand=o.get("strand"), do_long="long" in o, zero_gap="zeroGap" in o,
        min_gapless=int(o.get("minGapless", 0)),
        q_min_gap=int(o.get("qMinGap", 0)), t_min_gap=int(o.get("tMinGap", 0)),
        q_max_gap=int(o.get("qMaxGap", 0)), t_max_gap=int(o.get("tMaxGap", 0)),
        q_min_size=int(o.get("qMinSize", 0)),
        q_max_size=int(o.get("qMaxSize", BIGNUM)),
        t_min_size=int(o.get("tMinSize", 0)),
        t_max_size=int(o.get("tMaxSize", BIGNUM)),
        no_random="noRandom" in o, no_hap="noHap" in o)
    return 0


def cmd_chain_split(argv):
    from ..engines.chain_tools import chain_split
    pos, opts = _parse_kent_args(argv)
    if len(pos) < 2:
        print("usage: chainSplit outDir in.chain... [-q] [-lump=N]",
              file=sys.stderr)
        return 255
    chain_split(pos[0], pos[1:], split_on_q="q" in opts,
                lump=int(opts.get("lump", 0)))
    return 0


def cmd_chain_merge_sort(argv):
    from ..engines.chain_tools import chain_merge_sort
    pos, opts = _parse_kent_args(argv)
    if "inputList" in opts:
        with open(opts["inputList"]) as f:
            pos += [ln.strip() for ln in f if ln.strip()]
    if not pos:
        print("usage: chainMergeSort file(s) [-saveId] "
              "[-inputList=somefile] [-tempDir=somedir/] > out.chain",
              file=sys.stderr)
        return 255
    chain_merge_sort(pos, sys.stdout, save_id="saveId" in opts,
                     temp_dir=opts.get("tempDir", "./"))
    return 0


def cmd_chain_swap(argv):
    from ..engines.chain_tools import chain_swap
    pos, _ = _parse_kent_args(argv)
    if len(pos) != 2:
        print("usage: chainSwap in.chain out.chain", file=sys.stderr)
        return 255
    chain_swap(pos[0], sys.stdout if pos[1] == "stdout" else pos[1])
    return 0


def cmd_chain_anti_repeat(argv):
    from ..engines.chain_tools import chain_anti_repeat
    pos, opts = _parse_kent_args(argv)
    if len(pos) != 4:
        print("usage: chainAntiRepeat t.2bit q.2bit in.chain out.chain",
              file=sys.stderr)
        return 255
    chain_anti_repeat(pos[0], pos[1], pos[2],
                      sys.stdout if pos[3] == "stdout" else pos[3],
                      min_score=int(opts.get("minScore", 5000)),
                      no_check_score=int(opts.get("noCheckScore", 200000)))
    return 0


def cmd_chain_to_axt(argv):
    from ..engines.chain_tools import chain_to_axt
    pos, opts = _parse_kent_args(argv)
    if len(pos) != 4:
        print("usage: chainToAxt in.chain t.2bit q.2bit out.axt [-maxGap=N]",
              file=sys.stderr)
        return 255
    opts.get("maxChain")  # parsed but dead in the reference (chainToAxt.c:108)
    chain_to_axt(pos[0], pos[1], pos[2],
                 sys.stdout if pos[3] == "stdout" else pos[3],
                 max_gap=int(opts.get("maxGap", 100)),
                 min_score=float(opts.get("minScore", 0)),
                 min_id=float(opts.get("minId", 0)),
                 bed_out="bed" in opts)
    return 0


def cmd_chain_bridge(argv):
    from ..engines.chain_bridge import chain_bridge
    pos, opts = _parse_kent_args(argv)
    if len(pos) != 4:
        print("usage: chainBridge in.chain target.2bit query.2bit out.chain "
              "[-maxGap=N] [-scoreScheme=f] [-linearGap=f]", file=sys.stderr)
        return 255
    chain_bridge(pos[0], pos[1], pos[2],
                 sys.stdout if pos[3] == "stdout" else pos[3],
                 max_gap=int(opts.get("maxGap", 6000)),
                 linear_gap=opts.get("linearGap"),
                 score_scheme=opts.get("scoreScheme"))
    return 0


def cmd_net_syntenic(argv):
    from ..engines.net_tools import net_syntenic
    pos, _ = _parse_kent_args(argv)
    if len(pos) != 2:
        print("usage: netSyntenic in.net out.net", file=sys.stderr)
        return 255
    net_syntenic(pos[0], sys.stdout if pos[1] == "stdout" else pos[1])
    return 0


def cmd_net_filter(argv):
    from ..engines.net_tools import BIGNUM, net_filter, net_filter_line
    pos, o = _parse_kent_args(argv)
    if not pos:
        print("usage: netFilter in.net... [options] > out.net", file=sys.stderr)
        return 255
    kw = dict(
        q=o.get("q"), not_q=o.get("notQ"), t=o.get("t"), not_t=o.get("notT"),
        min_score=float(o.get("minScore", -BIGNUM)),
        max_score=float(o.get("maxScore", 9e99)),
        min_gap=int(o.get("minGap", 0)), min_ali=int(o.get("minAli", 0)),
        max_ali=int(o.get("maxAli", 0)),
        min_size_t=int(o.get("minSizeT", 0)),
        min_size_q=int(o.get("minSizeQ", 0)),
        q_start_min=int(o.get("qStartMin", -BIGNUM)),
        q_start_max=int(o.get("qStartMax", BIGNUM)),
        q_end_min=int(o.get("qEndMin", -BIGNUM)),
        q_end_max=int(o.get("qEndMax", BIGNUM)),
        t_start_min=int(o.get("tStartMin", -BIGNUM)),
        t_start_max=int(o.get("tStartMax", BIGNUM)),
        t_end_min=int(o.get("tEndMin", -BIGNUM)),
        t_end_max=int(o.get("tEndMax", BIGNUM)),
        q_overlap_start=int(o.get("qOverlapStart", -BIGNUM)),
        q_overlap_end=int(o.get("qOverlapEnd", BIGNUM)),
        t_overlap_start=int(o.get("tOverlapStart", -BIGNUM)),
        t_overlap_end=int(o.get("tOverlapEnd", BIGNUM)),
        syn="syn" in o, non_syn="nonsyn" in o, chimp_syn="chimpSyn" in o,
        min_top_score=float(o.get("minTopScore", 300000)),
        min_syn_score=float(o.get("minSynScore", 200000)),
        min_syn_size=float(o.get("minSynSize", 20000)),
        min_syn_ali=float(o.get("minSynAli", 10000)),
        max_far=float(o.get("maxFar", 200000)),
        fill_only="fill" in o, gap_only="gap" in o,
        types=o.get("type"), no_random="noRandom" in o, no_hap="noHap" in o)
    if "line" in o:
        net_filter_line(pos, sys.stdout, **kw)
    else:
        net_filter(pos, sys.stdout, **kw)
    return 0


def cmd_net_to_bed(argv):
    from ..engines.net_tools import net_to_bed
    pos, opts = _parse_kent_args(argv)
    if len(pos) != 2:
        print("usage: netToBed in.net out.bed [-maxGap=N] [-minFill=N]",
              file=sys.stderr)
        return 255
    net_to_bed(pos[0], sys.stdout if pos[1] == "stdout" else pos[1],
               max_gap=int(opts["maxGap"]) if "maxGap" in opts else None,
               min_fill=int(opts["minFill"]) if "minFill" in opts else None)
    return 0


def cmd_net_split(argv):
    from ..engines.net_tools import net_split
    pos, _ = _parse_kent_args(argv)
    if len(pos) != 2:
        print("usage: netSplit in.net outDir", file=sys.stderr)
        return 255
    net_split(pos[0], pos[1])
    return 0


def cmd_net_to_axt(argv):
    from ..engines.net_tools import net_to_axt
    pos, opts = _parse_kent_args(argv)
    if len(pos) != 5:
        print("usage: netToAxt in.net in.chain t.2bit q.2bit out.axt "
              "[-maxGap=N] [-qChain] [-noSplit] [-gapOut=gap.tab]",
              file=sys.stderr)
        return 255
    net_to_axt(pos[0], pos[1], pos[2], pos[3],
               sys.stdout if pos[4] == "stdout" else pos[4],
               max_gap=int(opts.get("maxGap", 100)),
               q_chain="qChain" in opts,
               split_on_insert="noSplit" not in opts,
               gap_out=opts.get("gapOut"))
    return 0




def cmd_psl_mrna_cover(argv):
    from ..engines.converters import psl_mrna_cover
    pos, opts = _parse_kent_args(argv)
    if len(pos) != 2:
        print("usage: pslMrnaCover mrna.psl mrna.fa [-minSize=N] "
              "[-listZero=zero.tab]", file=sys.stderr)
        return 255
    psl_mrna_cover(pos[0], pos[1], sys.stdout,
                   min_size=int(opts.get("minSize", 100)),
                   list_zero=opts.get("listZero"))
    return 0


def cmd_lav_to_psl(argv):
    from ..engines.lav_tools import lav_to_psl
    pos, opts = _parse_kent_args(argv)
    if len(pos) != 2:
        print("usage: lavToPsl in.lav out.psl [-target-strand=c] [-bed] "
              "[-scoreFile=f]", file=sys.stderr)
        return 255
    lav_to_psl(pos[0], sys.stdout if pos[1] == "stdout" else pos[1],
               target_strand=opts.get("target-strand", ""),
               bed="bed" in opts, score_file=opts.get("scoreFile"))
    return 0


def cmd_lav_to_axt(argv):
    from ..engines.lav_tools import lav_to_axt
    pos, opts = _parse_kent_args(argv)
    if len(pos) != 4:
        print("usage: lavToAxt in.lav tNibDir qNibDir out.axt [-fa] [-tfa] "
              "[-dropSelf] [-scoreScheme=f]", file=sys.stderr)
        return 255
    lav_to_axt(pos[0], pos[1], pos[2],
               sys.stdout if pos[3] == "stdout" else pos[3],
               q_is_fa="fa" in opts, t_is_fa="tfa" in opts,
               drop_self="dropSelf" in opts,
               score_scheme=opts.get("scoreScheme"))
    return 0


def cmd_axt_to_psl(argv):
    from ..engines.converters import axt_to_psl
    pos, _ = _parse_kent_args(argv)
    if len(pos) != 4:
        print("usage: axtToPsl in.axt tSizes qSizes out.psl", file=sys.stderr)
        return 255
    axt_to_psl(pos[0], pos[1], pos[2],
               sys.stdout if pos[3] == "stdout" else pos[3])
    return 0


def cmd_axt_sort(argv):
    from ..engines.converters import axt_sort
    pos, opts = _parse_kent_args(argv)
    if len(pos) != 2:
        print("usage: axtSort in.axt out.axt [-byScore] [-query]",
              file=sys.stderr)
        return 255
    axt_sort(pos[0], sys.stdout if pos[1] == "stdout" else pos[1],
             by_score="byScore" in opts, by_query="query" in opts)
    return 0


def cmd_axt_swap(argv):
    from ..engines.converters import axt_swap
    pos, _ = _parse_kent_args(argv)
    if len(pos) != 4:
        print("usage: axtSwap in.axt tSizes qSizes out.axt", file=sys.stderr)
        return 255
    axt_swap(pos[0], pos[1], pos[2],
             sys.stdout if pos[3] == "stdout" else pos[3])
    return 0


def cmd_filter_axt(argv):
    from ..engines.drivers import filter_axt_identity_entropy
    if len(argv) != 5:
        print("usage: filterAxtIdentityEntropy input.axt minSeqIdent "
              "minEntropy windowSize output.axt", file=sys.stderr)
        return 255
    filter_axt_identity_entropy(argv[0], float(argv[1]), float(argv[2]),
                                int(argv[3]),
                                sys.stdout if argv[4] == "stdout" else argv[4])
    return 0


def cmd_extract_syn_inv(argv):
    from ..engines.drivers import extract_syn_inv_chains, INT_MAX
    pos = [a for a in argv if not a.startswith("-")]
    opts = {}
    i = 0
    while i < len(argv):
        if argv[i] in ("-keepSynNetsWithScore", "-keepInvNetsWithScore"):
            opts[argv[i].lstrip("-")] = int(argv[i + 1])
            i += 2
        else:
            i += 1
    pos = [a for a in argv if not a.startswith("-")
           and not a.lstrip("-").isdigit()]
    if len(pos) != 3:
        print("usage: ExtractSynInvChainsFromNet input.net input.chain "
              "output.chain [-keepSynNetsWithScore N] "
              "[-keepInvNetsWithScore N]", file=sys.stderr)
        return 255
    extract_syn_inv_chains(
        pos[0], pos[1], sys.stdout if pos[2] == "stdout" else pos[2],
        opts.get("keepSynNetsWithScore", INT_MAX),
        opts.get("keepInvNetsWithScore", INT_MAX))
    return 0


def _parse_lastz_parameters(s: str) -> dict:
    """Map a patchChain -lastzParameters string onto aligner knobs.

    The reference passes the string verbatim to lastz
    (patchChain.perl:23,234); we honor the knobs our aligner plays the
    role of: Q= (score scheme file), K= (hsp threshold), L= (gapped
    threshold), W= (seed length).  --format / M= / T= and other output
    or masking-count options have no analog and are ignored."""
    out = {}
    for tok in s.split():
        if tok.startswith("Q="):
            out["score_scheme"] = tok[2:]
        elif tok.startswith("K="):
            out["hsp_threshold"] = int(tok[2:])
        elif tok.startswith("L="):
            out["gapped_threshold"] = int(tok[2:])
        elif tok.startswith("W="):
            out["seed_len"] = int(tok[2:])
    return out


def cmd_patch_chain(argv):
    from ..engines.drivers import patch_chain, patch_chain_make_jobs
    pos, o = _parse_kent_args(argv)
    if len(pos) not in (5, 6):
        print("usage: patchChain in.chain t.2bit q.2bit t.sizes q.sizes "
              "[out.psl]\n"
              "  5 args (reference mode): emit -numJobs job scripts into "
              "-jobDir + -jobList, outputs to -outputDir/patch<i>.psl\n"
              "  6 args: align in-process, write out.psl "
              "[-numShards=N -shard=N]\n"
              "  [options: -chainMinScore=N -gapMinSizeT=N ... "
              "-scoreScheme=HoxD55.q -lastzParameters=\"K=1500 L=2500 "
              "W=5 Q=...\" -unmask -minIdentity=N -minEntropy=F "
              "-windowSize=N]", file=sys.stderr)
        return 255
    lz = _parse_lastz_parameters(o.get("lastzParameters", ""))
    if len(pos) == 5:
        # reference signature: write cluster job scripts (patchChain.perl
        # :181-267); each job runs this CLI's sharded in-process mode
        passthrough = [a for a in argv
                       if a.startswith("-") and not any(
                           a.lstrip("-").startswith(k) for k in
                           ("numJobs", "jobDir", "outputDir", "jobList"))]
        n = patch_chain_make_jobs(
            pos[0], pos[1], pos[2], pos[3], pos[4],
            num_jobs=int(o.get("numJobs", 1000)),
            job_dir=o.get("jobDir", "doPatchChain"),
            output_dir=o.get("outputDir", "doPatchChain"),
            job_list=o.get("jobList", "jobList"),
            passthrough=passthrough)
        print(f"DONE: wrote {n} job scripts "
              f"({o.get('jobList', 'jobList')} lists them)")
        return 0
    patch_chain(
        pos[0], pos[1], pos[2], pos[3], pos[4],
        sys.stdout if pos[5] == "stdout" else pos[5],
        chain_min_score=int(o.get("chainMinScore", 0)),
        chain_min_size_t=int(o.get("chainMinSizeT", 0)),
        chain_min_size_q=int(o.get("chainMinSizeQ", 0)),
        gap_min_t=int(o.get("gapMinSizeT", 10)),
        gap_min_q=int(o.get("gapMinSizeQ", 10)),
        gap_max_t=int(o.get("gapMaxSizeT", 100000)),
        gap_max_q=int(o.get("gapMaxSizeQ", 100000)),
        score_scheme=lz.get("score_scheme", o.get("scoreScheme")),
        seed_len=lz.get("seed_len", int(o.get("seedLen", 5))),
        hsp_threshold=lz.get("hsp_threshold",
                             int(o.get("hspThreshold", 1500))),
        gapped_threshold=lz.get("gapped_threshold",
                                int(o.get("gappedThreshold", 2500))),
        min_identity=float(o.get("minIdentity", 0)),
        min_entropy=float(o.get("minEntropy", 0)),
        window_size=int(o.get("windowSize", 0)),
        num_shards=int(o.get("numShards", 1)),
        shard_index=int(o.get("shard", 0)),
        unmask="unmask" in o)
    return 0


def cmd_filter_chains_pipeline(argv):
    from ..engines.drivers import filter_chains_net_filter_nets, INT_MAX
    pos, o = _parse_kent_args(argv)
    if len(pos) != 8:
        print("usage: FilterChainsNetFilterNets in.chain in.net out.chain "
              "out.net t.2bit q.2bit t.sizes q.sizes -minScore=a,b "
              "-minSizeT=a,b -minSizeQ=a,b [-keepSynNetsWithScore=N] "
              "[-keepInvNetsWithScore=N]", file=sys.stderr)
        return 255
    filter_chains_net_filter_nets(
        pos[0], pos[1], pos[2],
        sys.stdout if pos[3] == "stdout" else pos[3],
        pos[4], pos[5], pos[6], pos[7],
        [int(x) for x in o.get("minScore", "0").split(",")],
        [int(x) for x in o.get("minSizeT", "0").split(",")],
        [int(x) for x in o.get("minSizeQ", "0").split(",")],
        keep_syn_nets_with_score=int(o.get("keepSynNetsWithScore", INT_MAX)),
        keep_inv_nets_with_score=int(o.get("keepInvNetsWithScore", INT_MAX)))
    return 0




def cmd_chain_to_psl_basic(argv):
    from ..engines.chain_tools import chain_to_psl_basic
    pos, _ = _parse_kent_args(argv)
    if len(pos) != 2:
        print("usage: chainToPslBasic in.chain out.psl", file=sys.stderr)
        return 255
    chain_to_psl_basic(pos[0], sys.stdout if pos[1] == "stdout" else pos[1])
    return 0


def cmd_chain_to_psl(argv):
    from ..engines.chain_tools import chain_to_psl
    pos, _ = _parse_kent_args(argv)
    if len(pos) != 6:
        print("usage: chainToPsl in.chain tSizes qSizes t.2bit q.2bit out.psl",
              file=sys.stderr)
        return 255
    chain_to_psl(pos[0], pos[1], pos[2], pos[3], pos[4],
                 sys.stdout if pos[5] == "stdout" else pos[5])
    return 0


def cmd_chain_overlap(argv):
    from ..engines.chain_tools import chain_overlap
    pos, opts = _parse_kent_args(argv)
    if len(pos) != 1:
        print("usage: chainOverlap chainFile [-query] > out.chain",
              file=sys.stderr)
        return 255
    chain_overlap(pos[0], sys.stdout, on_query="query" in opts)
    return 0


def cmd_axt_to_maf(argv):
    from ..engines.maf_tools import axt_to_maf
    pos, opts = _parse_kent_args(argv)
    if len(pos) != 4:
        print("usage: axtToMaf in.axt tSizes qSizes out.maf [-qPrefix=XX.] "
              "[-tPrefix=YY.] [-score] [-scoreZero]", file=sys.stderr)
        return 255
    axt_to_maf(pos[0], pos[1], pos[2],
               sys.stdout if pos[3] == "stdout" else pos[3],
               q_prefix=opts.get("qPrefix", ""),
               t_prefix=opts.get("tPrefix", ""),
               rescore="score" in opts, score_zero="scoreZero" in opts,
               t_split="tSplit" in opts)
    return 0


def cmd_maf_to_axt(argv):
    from ..engines.maf_tools import maf_to_axt
    pos, opts = _parse_kent_args(argv)
    if len(pos) != 4:
        print("usage: mafToAxt in.maf tName qName out.axt [-stripDb]",
              file=sys.stderr)
        return 255
    maf_to_axt(pos[0], pos[1], pos[2],
               sys.stdout if pos[3] == "stdout" else pos[3],
               strip_db="stripDb" in opts)
    return 0


def cmd_maf_to_psl(argv):
    from ..engines.maf_tools import maf_to_psl
    pos, _ = _parse_kent_args(argv)
    if len(pos) != 4:
        print("usage: mafToPsl querySrc targetSrc in.maf out.psl",
              file=sys.stderr)
        return 255
    maf_to_psl(pos[0], pos[1], pos[2],
               sys.stdout if pos[3] == "stdout" else pos[3])
    return 0


def cmd_maf_to_fa(argv):
    from ..engines.maf_tools import maf_to_fa
    pos, opts = _parse_kent_args(argv)
    if len(pos) != 2:
        print("usage: mafToFa in.maf out.fa [-stripDotsDashes]", file=sys.stderr)
        return 255
    maf_to_fa(pos[0], sys.stdout if pos[1] == "stdout" else pos[1],
              strip_dots_dashes="stripDotsDashes" in opts)
    return 0


def cmd_maf_ranges(argv):
    from ..engines.maf_tools import maf_ranges
    pos, opts = _parse_kent_args(argv)
    if len(pos) != 3:
        print("usage: mafRanges in.maf db out.bed [-otherDb=oDb] [-notAllOGap]",
              file=sys.stderr)
        return 255
    maf_ranges(pos[0], pos[1], sys.stdout if pos[2] == "stdout" else pos[2],
               other_db=opts.get("otherDb"),
               not_all_o_gap="notAllOGap" in opts)
    return 0


def cmd_maf_no_align(argv):
    from ..engines.maf_tools import maf_no_align
    pos, _ = _parse_kent_args(argv)
    if len(pos) != 2:
        print("usage: mafNoAlign in.maf out.bed", file=sys.stderr)
        return 255
    maf_no_align(pos[0], sys.stdout if pos[1] == "stdout" else pos[1])
    return 0


COMMANDS = {
    "scoreChain": cmd_score_chain,
    "axtChain": cmd_axt_chain,
    "chainSort": cmd_chain_sort,
    "chainPreNet": cmd_chain_pre_net,
    "chainStitchId": cmd_chain_stitch_id,
    "chainFilter": cmd_chain_filter,
    "chainSplit": cmd_chain_split,
    "chainMergeSort": cmd_chain_merge_sort,
    "chainSwap": cmd_chain_swap,
    "chainAntiRepeat": cmd_chain_anti_repeat,
    "chainToAxt": cmd_chain_to_axt,
    "chainBridge": cmd_chain_bridge,
    "netSyntenic": cmd_net_syntenic,
    "netFilter": cmd_net_filter,
    "netToBed": cmd_net_to_bed,
    "netSplit": cmd_net_split,
    "netToAxt": cmd_net_to_axt,
    "axtToPsl": cmd_axt_to_psl,
    "lavToPsl": cmd_lav_to_psl,
    "lavToAxt": cmd_lav_to_axt,
    "pslMrnaCover": cmd_psl_mrna_cover,
    "axtSort": cmd_axt_sort,
    "axtSwap": cmd_axt_swap,
    "chainToPsl": cmd_chain_to_psl,
    "chainToPslBasic": cmd_chain_to_psl_basic,
    "chainOverlap": cmd_chain_overlap,
    "axtToMaf": cmd_axt_to_maf,
    "mafToAxt": cmd_maf_to_axt,
    "mafToPsl": cmd_maf_to_psl,
    "mafToFa": cmd_maf_to_fa,
    "mafRanges": cmd_maf_ranges,
    "mafNoAlign": cmd_maf_no_align,
    "filterAxtIdentityEntropy": cmd_filter_axt,
    "ExtractSynInvChainsFromNet": cmd_extract_syn_inv,
    "patchChain": cmd_patch_chain,
    "FilterChainsNetFilterNets": cmd_filter_chains_pipeline,
    "chainNet": cmd_chain_net,
    "chainCleaner": cmd_chain_cleaner,
    "NetFilterNonNested": cmd_net_filter_non_nested,
    "netFilterNonNested": cmd_net_filter_non_nested,
    "RepeatFiller": cmd_repeat_filler,
    "repeatFiller": cmd_repeat_filler,
}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print("gat - GenomeAlignmentTools on JAX\ncommands: "
              + ", ".join(sorted(set(COMMANDS))), file=sys.stderr)
        return 0 if argv else 255
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd}; known: {', '.join(sorted(set(COMMANDS)))}",
              file=sys.stderr)
        return 255
    rest = []
    for a in argv[1:]:
        # kent-global flags installed by optionInit for every tool
        # (kent/src/lib/options.c): -verbose=N, -verboseLog=file
        if a.startswith("-verbose="):
            from ..utils.verbose import set_verbosity
            set_verbosity(int(a.split("=", 1)[1]))
        elif a.startswith("-verboseLog="):
            from ..utils.verbose import set_log_file
            set_log_file(a.split("=", 1)[1])
        elif a.startswith("-profile="):
            from ..utils.profiling import set_profile_dir
            set_profile_dir(a.split("=", 1)[1])
        else:
            rest.append(a)
    from ..utils.profiling import trace
    with trace():
        return COMMANDS[cmd](rest)


if __name__ == "__main__":
    sys.exit(main())
