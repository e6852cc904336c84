"""Pipelined corpus decode: host entropy workers feeding the device.

Production shape of the engine (BASELINE.json config 4: "batched 1080p corpus
decode with restart-interval parallel Huffman on 1 host"): the bit-serial
entropy work runs on all host cores (ctypes releases the GIL, so a thread
pool scales), and the dense coefficient->pixel stage runs on the device.
Within one ``decode_all`` call the host stage runs first, then one batched
device call per geometry bucket.

Per-image error isolation per SURVEY.md §5: a malformed image yields an error
record, never kills the batch.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


@dataclasses.dataclass
class DecodeResult:
    path: str
    rgb: np.ndarray | None
    error: str | None = None

    @property
    def ok(self) -> bool:
        return self.error is None


class CorpusDecoder:
    """Thread-pooled decode of many JPEGs.

    ``path="fast"`` uses the plane pipeline (:mod:`jpeg_tpu.ops.pixel`),
    ``"compat"`` the bit-exact block pipeline. Geometry-keyed jit caches mean a homogeneous
    corpus compiles once.
    """

    def __init__(self, workers: int | None = None, path: str = "compat",
                 rounding: str = "truncate", idct_mode: str = "exact"):
        self.workers = workers or os.cpu_count() or 1
        self.path = path
        self.rounding = rounding
        self.idct_mode = idct_mode
        self._pool = None  # persistent: see BatchedCorpusDecoder.__init__

    def _get_pool(self):
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.workers)
        return self._pool

    def _decode_one(self, path_or_bytes) -> DecodeResult:
        name = path_or_bytes if isinstance(path_or_bytes, str) else "<bytes>"
        try:
            if isinstance(path_or_bytes, str):
                with open(path_or_bytes, "rb") as f:
                    data = f.read()
            else:
                data = path_or_bytes
            from jpeg_tpu.io.container import parse_jpeg
            from jpeg_tpu.models.decoder import decode_plan, decode_plan_fast

            plan = parse_jpeg(data)
            if self.path == "fast":
                rgb = decode_plan_fast(plan, rounding=self.rounding,
                                       idct_mode=self.idct_mode)
            else:
                rgb = decode_plan(plan, rounding=self.rounding)
            return DecodeResult(name, np.asarray(rgb))
        except Exception as e:  # noqa: BLE001 — isolation boundary
            return DecodeResult(name, None, error=f"{type(e).__name__}: {e}")

    def decode_all(self, items) -> list[DecodeResult]:
        """Decode a list of paths (or bytes); order preserved."""
        return list(self._get_pool().map(self._decode_one, items))

    def decode_iter(self, items):
        """Generator variant for streaming consumption."""
        yield from self._get_pool().map(self._decode_one, items)


class BatchedCorpusDecoder:
    """Geometry-bucketed batch decode: the sharded batch feeder.

    Production shape for large homogeneous corpora (SURVEY.md C1): images
    are parsed and entropy-decoded on host workers, grouped by pipeline
    geometry, and each group runs through ONE batched (vmap) pixel-stage
    invocation — optionally sharded over a device mesh's
    ``data`` axis. Mixed-geometry corpora form multiple buckets; odd images
    fall back to single-image decode. Per-image error isolation throughout.
    """

    def __init__(self, workers: int | None = None, rounding: str = "truncate",
                 mesh=None, idct_mode: str = "exact"):
        self.workers = workers or os.cpu_count() or 1
        self.rounding = rounding
        self.mesh = mesh
        # idct_mode="approx" (opt-in): DEFAULT-precision IDCT contractions
        # in the pixel stage; measured error in docs/APPROX_QUALITY.md.
        # Entropy decode and the compat routes (12-bit, lossless, CMYK)
        # stay exact.
        self.idct_mode = idct_mode
        # Persistent worker pools, created lazily and REUSED across
        # decode_all calls: a fresh ThreadPoolExecutor per call means
        # fresh pthreads per corpus chunk, and every new thread brings a
        # new glibc arena + per-thread native scratch — measured ~1.3 GB
        # of unreclaimable RSS growth PER 32-image 4K chunk on the
        # endurance run, with zero live Python/jax
        # arrays. Stable threads -> stable arenas -> flat RSS.
        self._pool = None

    def _get_pool(self):
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.workers)
        return self._pool

    def _entropy_one(self, path_or_bytes):
        from jpeg_tpu.io.container import parse_jpeg
        from jpeg_tpu.models.decoder import PipelineGeometry
        from jpeg_tpu.ops.pixel import plane_path_supported
        from jpeg_tpu.runtime import native_decode_planes

        name = path_or_bytes if isinstance(path_or_bytes, str) else "<bytes>"
        try:
            if isinstance(path_or_bytes, str):
                with open(path_or_bytes, "rb") as f:
                    data = f.read()
            else:
                data = path_or_bytes
            plan = parse_jpeg(data)
            geom = PipelineGeometry.of(plan)
            if (getattr(plan, "lossless", False)
                    or not plane_path_supported(geom)):
                # Lossless (no coefficient planes at all), 12-bit (u16
                # output) and CMYK/YCCK/RGB-direct (the plane path bakes in
                # the YCbCr matrix) decode inline through the compat
                # pipeline ("compat" sentinel geometry, no bucketing).
                from jpeg_tpu.models.decoder import decode_plan

                rgb = np.asarray(decode_plan(plan, rounding=self.rounding))
                return (name, plan, "compat", rgb, None)
            if plan.progressive:
                from jpeg_tpu.models.decoder import progressive_planes

                # progressive_planes returns the runtime's per-thread
                # scratch buffer (same reuse contract as
                # native_decode_planes): copy before this worker thread
                # decodes another same-geometry image, or the stored
                # planes are silently overwritten (was a rare flake in
                # test_mixed_corpus_stress).
                planes = [p.copy() for p in progressive_planes(plan)]
            elif getattr(plan, "arith_code", False):
                # SOF9 sequential arithmetic: the QM decoder, not the
                # Huffman tier (routing these to native_decode_planes
                # raised "invalid Huffman prefix" — found by the r5 CLI
                # surface sweep; the non-batched path always handled it).
                from jpeg_tpu.runtime import native_decode_arith_planes

                planes = [p.copy()
                          for p in native_decode_arith_planes(plan)]
            else:
                planes = [p.copy() for p in
                          native_decode_planes(plan, n_threads=1)]
            return (name, plan, geom, planes, None)
        except Exception as e:  # noqa: BLE001 — isolation boundary
            return (name, None, None, None, f"{type(e).__name__}: {e}")

    def decode_all(self, items) -> list[DecodeResult]:
        from jpeg_tpu.ops.pixel import plan_quant_tables
        from jpeg_tpu.parallel.batch import decode_batch_fast

        parsed = list(self._get_pool().map(self._entropy_one, items))

        results: list[DecodeResult | None] = [None] * len(parsed)
        buckets: dict = {}
        for i, (name, plan, geom, planes, err) in enumerate(parsed):
            if err is not None:
                results[i] = DecodeResult(name, None, error=err)
            elif geom == "compat":  # decoded inline by the worker
                results[i] = DecodeResult(name, planes)
            else:
                buckets.setdefault(geom, []).append(i)

        n_dev = 1 if self.mesh is None else self.mesh.devices.size
        for geom, idxs in buckets.items():
            # Mesh sharding needs the batch divisible by the data axis; spill
            # the remainder to unsharded decode.
            spill_from = len(idxs) - (len(idxs) % n_dev) if self.mesh else len(idxs)
            for chunk, mesh in ((idxs[:spill_from], self.mesh),
                                (idxs[spill_from:], None)):
                if not chunk:
                    continue
                bp = [np.stack([parsed[i][3][c] for i in chunk])
                      for c in range(len(geom.sampling))]
                bq = np.stack([plan_quant_tables(parsed[i][1]) for i in chunk])
                try:
                    rgb = np.asarray(decode_batch_fast(
                        bp, bq, geom, self.rounding, mesh=mesh,
                        idct_mode=self.idct_mode))
                except Exception as e:  # noqa: BLE001 — bucket isolation
                    for i in chunk:
                        results[i] = DecodeResult(
                            parsed[i][0], None,
                            error=f"{type(e).__name__}: {e}")
                    continue
                for b, i in enumerate(chunk):
                    results[i] = DecodeResult(parsed[i][0], rgb[b])
        return results  # type: ignore[return-value]
