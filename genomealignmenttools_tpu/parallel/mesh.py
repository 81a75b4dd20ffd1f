"""Mesh construction and sharded batched rescoring.

Work-unit sharding: per-base block scoring is embarrassingly parallel over
blocks, so the block SoA is sharded along axis 0 of a 1-D ("data",) mesh;
both genome code arrays and the score LUT are replicated (they are
read-only and fit in device memory).  Per-shard results come back sharded and are
concatenated on host; chain order (and therefore every downstream byte) is
independent of the shard count.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.rescore import _block_scores_kernel


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


@functools.partial(jax.jit, static_argnames=("total_per_shard", "mesh"))
def _sharded_block_scores(t_codes, q_codes, lut, t_starts, q_starts, sizes,
                          total_per_shard: int, mesh: Mesh):
    """Per-block scores with blocks sharded over the mesh's data axis."""

    def per_shard(tc, qc, lut_, ts, qs, sz):
        return _block_scores_kernel(tc, qc, lut_, ts, qs, sz, total_per_shard)

    return jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(), P(), P(), P("data"), P("data"), P("data")),
        out_specs=P("data"),
    )(t_codes, q_codes, lut, t_starts, q_starts, sizes)


class ShardedBlockScorer:
    """Multi-chip version of DeviceBlockScorer: shards blocks round-robin
    into equal per-device chunks (padded), replicates genomes."""

    def __init__(self, lut: np.ndarray, mesh: Mesh | None = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.lut = jnp.asarray(np.asarray(lut, dtype=np.int32))
        self.n_dev = self.mesh.devices.size
        self._genome_cache: dict[int, jax.Array] = {}

    def put_genome(self, codes: np.ndarray) -> jax.Array:
        key = id(codes)
        if key not in self._genome_cache:
            self._genome_cache[key] = jax.device_put(
                jnp.asarray(codes),
                NamedSharding(self.mesh, P()))
        return self._genome_cache[key]

    def block_scores(self, t_codes: np.ndarray, q_codes: np.ndarray,
                     blocks: np.ndarray) -> np.ndarray:
        """int64[n] per-block scores, sharded across the mesh."""
        n = blocks.shape[0]
        if n == 0:
            return np.zeros(0, np.int64)
        nd = self.n_dev
        sizes = (blocks[:, 1] - blocks[:, 0]).astype(np.int64)
        # contiguous partition of blocks into nd shards with balanced bases
        # (simple equal-count split; blocks are fine-grained enough)
        per = -(-n // nd)
        n_pad_shard = self._pow2(per, 256)
        total_pad = self._pow2(
            int(max((sizes[i * per:(i + 1) * per].sum() for i in range(nd)),
                    default=0)), 4096)
        ts = np.zeros((nd, n_pad_shard), np.int32)
        qs = np.zeros((nd, n_pad_shard), np.int32)
        sz = np.zeros((nd, n_pad_shard), np.int32)
        for d in range(nd):
            chunk = blocks[d * per:(d + 1) * per]
            k = chunk.shape[0]
            ts[d, :k] = chunk[:, 0]
            qs[d, :k] = chunk[:, 2]
            sz[d, :k] = chunk[:, 1] - chunk[:, 0]
        sharding = NamedSharding(self.mesh, P("data"))
        out = _sharded_block_scores(
            self.put_genome(t_codes), self.put_genome(q_codes), self.lut,
            jax.device_put(ts.reshape(nd * n_pad_shard), sharding),
            jax.device_put(qs.reshape(nd * n_pad_shard), sharding),
            jax.device_put(sz.reshape(nd * n_pad_shard), sharding),
            total_pad, self.mesh)
        out = np.asarray(out).reshape(nd, n_pad_shard)
        return np.concatenate(
            [out[d, :min(per, n - d * per)] for d in range(nd)
             if d * per < n]).astype(np.int64)

    @staticmethod
    def _pow2(x: int, floor: int) -> int:
        p = floor
        while p < x:
            p *= 2
        return p


@functools.partial(jax.jit, static_argnames=("mesh",))
def _sharded_pair_scores(c8, packed_lut, mesh: Mesh):
    """Pair-tile chunk scores with rows sharded over the data axis.

    Rows are independent, so the shard_map body is just the single-chip
    combined-tile pair kernel; no collectives are needed until the (tiny)
    host combine.
    """
    from ..ops.pair_rescore import _pair_vals

    def body(c, pl):
        return jnp.sum(_pair_vals(c, pl), axis=1, dtype=jnp.int16)

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("data"), P()),
        out_specs=P("data"),
    )(c8, packed_lut)


class ShardedPairScorer:
    """Multi-chip pair-packed scorer: dense (M, CHUNK) uint8 tiles sharded
    row-wise over the data axis (tiles are genome-agnostic, so no genome
    replication is needed at all - the pack stage resolved coordinates)."""

    def __init__(self, lut: np.ndarray, mesh: Mesh | None = None):
        from ..ops.pair_rescore import pack_lut
        self.mesh = mesh if mesh is not None else make_mesh()
        self.packed_lut = jnp.asarray(pack_lut(np.asarray(lut)))
        self.n_dev = self.mesh.devices.size

    def chunk_scores(self, c8: np.ndarray) -> np.ndarray:
        """(M_pad, CHUNK) combined uint8 tiles -> int16[M_pad] scores.

        M_pad must be divisible by the device count (ROW_PAD=1024 covers
        any power-of-two mesh)."""
        sharding = NamedSharding(self.mesh, P("data"))
        out = _sharded_pair_scores(
            jax.device_put(jnp.asarray(c8), sharding),
            self.packed_lut, self.mesh)
        return np.asarray(out)


class ShardedChainScorer:
    """Multi-chip whole-workload (global, local, ali) chain scoring.

    The data-parallel decomposition of the rescore path (SURVEY §2.4 /
    §5.8): dense pair tiles are row-sharded over the mesh's data axis
    (jax.device_put with a ("data",) NamedSharding), the chunk-sum kernel
    partitions with zero communication, and the staged combine
    (ops/pair_rescore._pair_chain_scores) runs under GSPMD, which inserts
    the (tiny: the row-aggregate carries and final per-chain gathers)
    collectives automatically.  Only (n_chains, 2) is fetched.

    Results are bit-identical to the single-chip and host paths for any
    device count - chain order is input order, so every downstream byte
    is topology-invariant.
    """

    def __init__(self, scheme, gap_calc, t_genome, q_genome,
                 mesh: Mesh | None = None):
        from ..ops.pair_rescore import PairBlockScorer, PairChainScorer
        self.scheme = scheme
        self.gap_calc = gap_calc
        self.mesh = mesh if mesh is not None else make_mesh()
        tile_sharding = NamedSharding(self.mesh, P("data", None))
        meta_sharding = NamedSharding(self.mesh, P("data"))
        self._dev = PairBlockScorer(np.asarray(scheme.lut), t_genome,
                                    q_genome, tile_sharding=tile_sharding)
        self._pcs = PairChainScorer(self._dev, gap_calc,
                                    meta_sharding=meta_sharding)

    def score_chains(self, chains: list) -> list[tuple[float, float, int]]:
        from ..ops.rescore import DeviceChainScorer
        jobs, order = DeviceChainScorer._grouped(self, chains)
        scored = self._pcs.score(jobs, [chains[i].n_blocks for i in order])
        results: list = [None] * len(chains)
        for k, i in enumerate(order):
            results[i] = scored[k]
        return results
