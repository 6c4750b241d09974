"""Multi-device index serving: the engine's distributed query path.

ShardedIndex places a SketchIndex's index row-sharded over the mesh's 'tp'
axis (each device owns a contiguous genome range — the TP analog of
sharding NIQKI's bucket table, /root/reference/src/niqki_index.cpp:27) and
runs hit counting under shard_map with query batches sharded over 'dp'.
Count blocks land sharded over both axes and are gathered once per batch.

The per-shard count is the bit-plane count (ops/bcount) whenever its shape
gate holds — each device holds its shard as W+1 bit-planes — with the dense
XLA compare as the fallback. Counts are identical to the single-device path
by construction (sharding is a layout choice).

Multi-host: call `init_distributed()` (jax.distributed) on every host before
building the mesh; the same code then spans hosts — there is no other code
path to maintain.
"""

from __future__ import annotations

import os

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..debug import note
from ..index import SketchIndex
from .mesh import make_mesh, default_mesh_shape
from .sharded import (sharded_count, sharded_count_planes,
                      sharded_count_planes_topk, sharded_selfjoin)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize the multi-host JAX runtime (no-op for single-process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


class ShardedIndex:
    """Row-sharded device-resident index for batched multi-device queries."""

    def __init__(self, index: SketchIndex, mesh: Mesh | None = None,
                 impl: str | None = None):
        """``impl``: the bit-plane count implementation (bcount.IMPLS);
        default bcount.count_impl(), i.e. $NIQKI_TPU_COUNT and the
        backend."""
        from ..ops import bcount
        if mesh is None:
            devs = jax.devices()
            dp, tp = default_mesh_shape(len(devs))
            mesh = make_mesh(devs, dp=dp, tp=tp)
        self.mesh = mesh
        self.params = index.params
        self.names = list(index.names)
        self.G = index.G
        self._tp = mesh.shape["tp"]
        self._dp = mesh.shape["dp"]
        self._fns: dict = {}     # compiled sparse-path fns by (kind, shape)
        p = self.params
        if bcount.supported(p.F, p.W):
            self._kernel = "planes"
            self._impl = impl or bcount.count_impl()
            row_align = self._tp * bcount.TILE_G
        else:
            self._kernel = "dense"
            row_align = self._tp
        mat = index._stored()  # empty slots already mapped to non-matching
        pad_g = -self.G % row_align
        self._Gp = self.G + pad_g
        if pad_g:
            # Padding rows of -2 can never match a fingerprint (valid range
            # [-1, 2^W)); they are sliced off the count output anyway.
            # Hugepage destination (niqki_tpu/hostmem.py).
            from ..hostmem import big_empty
            padded = big_empty((self._Gp, mat.shape[1]), np.int32)
            padded[:self.G] = mat
            padded[self.G:] = -2
            mat = padded
        if self._kernel == "planes":
            mat_dev = jax.device_put(
                mat, NamedSharding(mesh, P("tp", None)))
            self._planes = jax.jit(
                bcount.pack_bitplanes,
                static_argnames=("W", "query"),
                out_shardings=NamedSharding(mesh, P(None, "tp", None)),
            )(mat_dev, W=p.W, query=False)
            self._count = sharded_count_planes(mesh, self._impl)
            self._qpack = jax.jit(
                bcount.pack_bitplanes, static_argnames=("W", "query"),
                out_shardings=NamedSharding(mesh, P(None, "dp", None)))
            note("count:" + self._impl)
        else:
            self._mat = jax.device_put(
                mat, NamedSharding(mesh, P("tp", None)))
            self._count = sharded_count(mesh)

    @classmethod
    def from_checkpoint(cls, directory: str, mesh: Mesh | None = None,
                        impl: str | None = None) -> "ShardedIndex":
        """Mesh-direct serving restart: build a ShardedIndex straight from
        a sharded checkpoint (v2/v3), placing each mesh 'tp' shard's
        bit-planes on its owning device via jax.make_array_from_callback —
        NO global host matrix is ever assembled, and in a multi-process
        mesh each process reads only its addressable shards' byte ranges
        (hostmem.read_direct ranged reads).

        v3 checkpoints (save_sharded(planes=True)) load their persisted
        planes directly; v2 checkpoints read the needed row ranges and
        host-pack them (bcount.np_pack_bitplanes — bit-identical with the
        device pack). The reference's load ctor is single-node
        (/root/reference/src/niqki_index.cpp:63-102); this is the SURVEY §5
        'native sharded format' completed for pod-shaped serving."""
        import json
        import zlib

        from .. import hostmem
        from ..ops import bcount
        from ..params import SketchParams

        with open(os.path.join(directory, "manifest.json")) as f:
            manifest = json.load(f)
        fmt = manifest.get("format")
        if fmt not in ("niqki_tpu.sharded.v2", "niqki_tpu.sharded.v3"):
            raise ValueError(f"mesh-direct load supports v2/v3, got {fmt} "
                             "(v1: use SketchIndex.load_sharded)")
        pp = manifest["params"]
        params = SketchParams(
            lF=pp["lF"], K=pp["K"], W=pp["W"], H=pp["H"],
            min_fract=pp["min_fract"],
            stale_mask_M=pp.get("stale_mask_M"),
            stale_maximal_remainder=pp.get("stale_maximal_remainder"))
        if not bcount.supported(params.F, params.W):
            raise ValueError("mesh-direct load needs the bit-plane count "
                             "shape gate (F%32==0, 1<=W<=30)")
        G = manifest["genomes"]
        names: list[str] = []
        for sh in manifest["shards"]:
            with open(os.path.join(directory, sh["names"]), "rb") as f:
                blob = f.read().decode()
            names.extend(blob.split("\n") if sh["hi"] > sh["lo"] else [])

        self = object.__new__(cls)
        if mesh is None:
            devs = jax.devices()
            dp, tp = default_mesh_shape(len(devs))
            mesh = make_mesh(devs, dp=dp, tp=tp)
        self.mesh = mesh
        self.params = params
        self.names = names
        self.G = G
        self._tp = mesh.shape["tp"]
        self._dp = mesh.shape["dp"]
        self._fns = {}
        self._impl = impl or bcount.count_impl()
        self._kernel = "planes"
        p = params
        W, F = p.W, p.F
        L = F // 32
        row_align = self._tp * bcount.TILE_G
        Gp = G + (-G % row_align)
        self._Gp = Gp
        shards = manifest["shards"]

        def fill_rows(out: np.ndarray, a: int, b: int) -> None:
            """Fill out (W+1, b-a, L) with planes of global rows [a, b) —
            ranged reads fan out over a thread pool (O_DIRECT preads and
            np_pack_bitplanes release the GIL; the serial per-plane loop
            was the measured wall of the S=15 mesh-direct restart)."""
            tasks = []
            for sh in shards:
                s_lo, s_hi = sh["lo"], sh["hi"]
                o_lo, o_hi = max(a, s_lo), min(b, s_hi)
                if o_hi <= o_lo:
                    continue
                if "planes" in sh:
                    path = os.path.join(directory, sh["planes"])
                    rows_s = s_hi - s_lo
                    for pl in range(W + 1):
                        tasks.append((hostmem.read_direct, path,
                                      out[pl, o_lo - a:o_hi - a],
                                      ((pl * rows_s) + (o_lo - s_lo))
                                      * L * 4))
                    continue

                def pack_shard(sh=sh, o_lo=o_lo, o_hi=o_hi):
                    s_lo2 = sh["lo"]
                    path2 = os.path.join(directory, sh["file"])
                    if sh["file"].endswith(".gz"):
                        with open(path2, "rb") as f:  # gz: no ranged IO
                            raw = zlib.decompress(f.read(), 31)
                        blk = np.frombuffer(raw, np.int32).reshape(-1, F)
                        blk = blk[o_lo - s_lo2:o_hi - s_lo2]
                    else:
                        blk = np.empty((o_hi - o_lo, F), np.int32)
                        hostmem.read_direct(path2, blk,
                                            (o_lo - s_lo2) * F * 4)
                    bcount.np_pack_bitplanes(blk, W,
                                             out=out[:, o_lo - a:o_hi - a])
                tasks.append((pack_shard,))
            if len(tasks) <= 1:
                for t in tasks:
                    t[0](*t[1:])
            else:
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(min(8, max(2, os.cpu_count()
                                                   or 2))) as ex:
                    list(ex.map(lambda t: t[0](*t[1:]), tasks))

        def cb(index):
            rows = index[1]
            a = rows.start or 0
            b = rows.stop if rows.stop is not None else Gp
            # hugepage-backed (niqki_tpu/hostmem.py)
            out = hostmem.big_empty((W + 1, b - a, L), np.uint32)
            real = min(b, G)
            if real > a:
                fill_rows(out, a, real)
            if b > real:       # padding rows: stored-invalid (-2) planes
                out[:W, real - a:] = 0
                out[W, real - a:] = 0xFFFFFFFF
            return out

        sharding = NamedSharding(mesh, P(None, "tp", None))
        self._planes = jax.make_array_from_callback((W + 1, Gp, L),
                                                    sharding, cb)
        self._count = sharded_count_planes(mesh, self._impl)
        self._qpack = jax.jit(
            bcount.pack_bitplanes, static_argnames=("W", "query"),
            out_shardings=NamedSharding(mesh, P(None, "dp", None)))
        note("count:" + self._impl)
        return self

    @staticmethod
    def _to_host(arr) -> np.ndarray:
        """Materialize a mesh-sharded result on the host. In a multi-process
        mesh the output shards live on other processes' devices, so a plain
        np.asarray would raise — gather across processes first;
        single-process meshes keep the zero-copy asarray."""
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils
            return np.asarray(multihost_utils.process_allgather(arr,
                                                                tiled=True))
        return np.asarray(arr)

    def topk_counts(self, q_sanitized: np.ndarray, cap: int,
                    min_score: int):
        """SPARSE multi-device hit counting: per-shard count + per-shard
        top-``cap`` with global gids (sharded_count_planes_topk) — only
        (count, gid) candidates cross d2h, never a dense (Q, G) block.

        q_sanitized must already be _query_side output (values in
        [-3, 2^W)). Returns (vals, gids, shard_cap) with vals/gids
        (Q, tp*shard_cap) int32, or None when the planes kernel is not
        this index's route (callers fall back to dense counts). A row
        overflowed shard s iff vals[row, s*shard_cap + shard_cap - 1]
        >= min_score."""
        if self._kernel != "planes" or min_score < 1:
            return None
        from ..ops.bcount import BLOCK_Q
        import jax.numpy as jnp
        q = np.atleast_2d(np.asarray(q_sanitized, np.int32))
        Q = len(q)
        q_align = self._dp * BLOCK_Q
        pad_q = -Q % q_align
        if pad_q:
            q = np.vstack([q, np.full((pad_q, q.shape[1]), -3, np.int32)])
        key = ("topk", cap)
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = sharded_count_planes_topk(
                self.mesh, cap=cap, impl=self._impl)
        qp = self._qpack(jnp.asarray(q), W=self.params.W, query=True)
        vals, gids = fn(qp, self._planes, np.int32(min_score))
        vals, gids = self._to_host(vals), self._to_host(gids)
        shard_cap = vals.shape[1] // self._tp
        return vals[:Q], gids[:Q], shard_cap

    def selfjoin_block(self, lo: int, B: int, cap: int | None,
                       min_score: int):
        """All-vs-all block [lo, lo+B) vs the whole sharded index with zero
        query h2d (sharded_selfjoin). cap set: (vals, gids, shard_cap),
        uint16-wrapped counts, per-shard top-k with global gids. cap None:
        dense (B, Gp) uint16 rows. [lo, lo+B) must lie inside [0, Gp)."""
        if self._kernel != "planes":
            return None
        assert 0 <= lo and lo + B <= self._Gp
        key = ("selfjoin", B, cap)
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = sharded_selfjoin(
                self.mesh, B=B, cap=cap, impl=self._impl)
        res = fn(self._planes, np.int32(lo), np.int32(min_score))
        if cap is None:
            return self._to_host(res)
        vals, gids = self._to_host(res[0]), self._to_host(res[1])
        return vals, gids, vals.shape[1] // self._tp

    def counts(self, q_sketches: np.ndarray) -> np.ndarray:
        """(Q, G) hit counts; Q is padded to the mesh's block multiple."""
        from ..ops.bcount import BLOCK_Q
        q = np.atleast_2d(np.asarray(q_sketches, np.int32))
        q = np.where((q < 0) | (q >= self.params.fingerprint_range), -3, q)
        Q = len(q)
        q_align = self._dp * (BLOCK_Q if self._kernel == "planes" else 1)
        pad_q = -Q % q_align
        if pad_q:
            q = np.vstack([q, np.full((pad_q, q.shape[1]), -3, np.int32)])
        if self._kernel == "planes":
            qp = self._qpack(jnp.asarray(q), W=self.params.W, query=True)
            out = self._count(qp, self._planes)
        else:
            qd = jax.device_put(q, NamedSharding(self.mesh, P("dp", None)))
            out = self._count(qd, self._mat)
        return self._to_host(out)[:Q, :self.G]

    def hits(self, q_sketch: np.ndarray):
        from ..index import hits_from_counts
        return hits_from_counts(self.counts(q_sketch[None, :])[0],
                                self.params.min_score)
