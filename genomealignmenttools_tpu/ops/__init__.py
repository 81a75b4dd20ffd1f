"""Hot loops: chain rescoring (JAX/XLA device paths, native host path),
banded DP and the seed-extend gap aligner."""
