"""genomealignmenttools_tpu - a genome-alignment chain/net engine on JAX.

A from-scratch JAX/XLA + native C++ re-design of the capabilities of
hillerlab/GenomeAlignmentTools (reference: /root/reference):

- exact chain (re)scoring          (ref: src/scoreChain/scoreChain.c)
- chain netting + exact sub-net rescoring  (ref: src/chainNet/chainNet.c)
- chain-breaking-alignment removal (ref: src/chainCleaner/chainCleaner.c)
- chain-gap repeat filling         (ref: src/RepeatFiller.py)
- sensitive patch alignment        (ref: src/patchChain.perl)
- non-nested net filtering         (ref: src/NetFilterNonNested.perl)
- the supporting UCSC chain/net tool-suite (ref: kent/src/hg/mouseStuff)

Architecture (bottom-up):
  formats/   byte-exact host codecs (chain, net, 2bit, bed, axt, psl, matrices)
  device/    device data model (packed genomes, chain SoA, score LUTs)
  ops/       JAX/XLA device paths + native host paths (block rescore, gap
             cost, local-score scan, banded affine DP, seed finding)
  engines/   tool engines combining host logic with device kernels
  parallel/  jax.sharding mesh distribution of work units + deterministic merge
  cli/       drop-in command surface
"""

__version__ = "0.1.0"
