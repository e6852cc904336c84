"""Benchmark: 4K baseline-JPEG decode throughput on one NVIDIA GPU.

    python bench.py

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": "frames/s", "vs_baseline": N, ...}

Headline: frames/s of the batched corpus route on 4K 4:2:0 q85 frames with
restart markers — ``BatchedCorpusDecoder.decode_all``, JPEG bytes in, u8
pixels back on the host, every transfer included. ``vs_baseline`` divides it
by single-threaded libjpeg (PIL) on the same host, ``vs_libjpeg_allcore`` by
libjpeg on all host cores (both null where PIL is not installed).

Stages benchmarked beside it:
- host: C++ entropy (single image, corpus mode, no-restart speculative,
  progressive, arithmetic, lossless), the host encoder;
- device: the plane pixel stage (exact and approx IDCT) with its share of
  the card's HBM roofline, the device forward transform, the batched 1080p
  stage.

Fails when JAX finds no GPU: a host rate is never reported as a device
number. All diagnostics go to stderr, each with the card's name and power
limit; stdout carries exactly the one JSON line.
"""

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from jpeg_tpu.utils.compile_cache import enable_compile_cache

# Published peaks by jax device_kind. Source: NVIDIA H100 Tensor Core GPU
# data sheet (SXM5 part, dense rates, at the 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "f32_flops": 67e12,
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "source": "NVIDIA H100 SXM data sheet (dense, 700 W)",
    },
}


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def median3(measure, reps=3):
    """Median of ``reps`` runs of a measurement callable returning fps."""
    return statistics.median(measure() for _ in range(reps))


def card() -> str:
    """``name, power.limit`` of the card, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def require_gpu():
    """(device_kind, peaks) of the GPU; exits when there is none or its
    kind has no entry in PEAKS."""
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench needs a GPU; JAX's backend is "
                         f"{jax.default_backend()}")
    kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise SystemExit(f"no published peaks for device kind {kind!r}")
    return kind, PEAKS[kind]


def make_4k_image(seed=0):
    from jpeg_tpu.io.corpus import synthetic_image

    return synthetic_image(3840, 2160, seed)


def make_4k_jpeg(img, restart=True, **kw):
    """4K 4:2:0 q85 through the repo's encoder; one restart interval per
    MCU row unless ``restart`` is False."""
    from jpeg_tpu.models.encoder import encode_rgb

    return encode_rgb(img, quality=85, subsampling=(2, 2),
                      restart_interval_mcus=240 if restart else 0, **kw)


def bench_libjpeg(data, iters=8):
    """(single-thread fps, all-core corpus-mode fps) of libjpeg via PIL,
    or (None, None) where PIL is not installed."""
    import io
    from concurrent.futures import ThreadPoolExecutor

    try:
        from PIL import Image
    except ImportError:
        return None, None

    def one(_=None):
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))

    one()
    t0 = time.perf_counter()
    for _ in range(iters):
        one()
    single = iters / (time.perf_counter() - t0)
    n = os.cpu_count() or 1
    with ThreadPoolExecutor(max_workers=n) as ex:
        list(ex.map(one, range(n)))
        t0 = time.perf_counter()
        list(ex.map(one, range(3 * iters)))
        allcore = 3 * iters / (time.perf_counter() - t0)
    return single, allcore


def bench_cpu_work_unit():
    """Fixed single-thread CPU work unit: SHA-256 over 64 MB, in MB/s — a
    host-speed denominator independent of libjpeg and of this repo."""
    import hashlib

    buf = bytes(16 << 20)
    hashlib.sha256(buf).digest()
    t0 = time.perf_counter()
    for _ in range(4):
        hashlib.sha256(buf).digest()
    return 64.0 / (time.perf_counter() - t0)


def corpus_mode(fn, iters=12):
    """fps with one frame per worker, all host cores busy."""
    from concurrent.futures import ThreadPoolExecutor

    n = os.cpu_count() or 1
    with ThreadPoolExecutor(max_workers=n) as ex:
        list(ex.map(fn, range(n)))  # warmup incl. per-thread buffers
        t0 = time.perf_counter()
        list(ex.map(fn, range(iters)))
        return iters / (time.perf_counter() - t0)


def loop_fps(fn, iters):
    """fps of ``fn()`` called back to back (it returns when done)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return iters / (time.perf_counter() - t0)


def device_time(fn, args, reps=10):
    """Median seconds of one jitted call, ended by block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def plane_batch(plan, batch):
    """Device-resident planes [B, ...] and q [B, ncomp, 8, 8] of one plan."""
    import jax.numpy as jnp

    from jpeg_tpu.ops.pixel import plan_quant_tables
    from jpeg_tpu.runtime import native_decode_planes

    planes = [jnp.broadcast_to(jnp.asarray(p), (batch,) + p.shape).copy()
              for p in native_decode_planes(plan)]
    q = jnp.broadcast_to(jnp.asarray(plan_quant_tables(plan)),
                         (batch,) + (len(planes), 8, 8)).copy()
    return planes, q


def bench_pixel_stage(plan, peaks, batch, idct_mode="exact"):
    """(frames/s, share of the HBM roofline) of the batched plane pixel
    stage. Minimum traffic per frame: the int16 planes once in, the u8
    [H, W, 3] pixels once out."""
    from jpeg_tpu.models.decoder import PipelineGeometry
    from jpeg_tpu.ops.pixel import geometry_plane_shapes, planes_to_rgb_fn

    geom = PipelineGeometry.of(plan)
    planes, q = plane_batch(plan, batch)
    fn = planes_to_rgb_fn(geom, idct_mode=idct_mode, batched=True)
    fps = batch / device_time(fn, (planes, q))
    frame_bytes = (sum(2 * r * c for r, c in geometry_plane_shapes(geom))
                   + 3 * geom.height * geom.width)
    return fps, fps * frame_bytes / peaks["hbm_bytes_per_s"]


def bench_device_encode(img, plan, batch=8):
    """frames/s of the device forward transform (colour, downsample, DCT,
    quantisation) on a batch of 4K frames."""
    import jax.numpy as jnp

    from jpeg_tpu.models.decoder import PipelineGeometry
    from jpeg_tpu.ops.pixel import forward_planes_fn, inverse_quant_tables

    geom = PipelineGeometry.of(plan)
    rgb = jnp.broadcast_to(jnp.asarray(img.transpose(2, 0, 1)),
                           (batch, 3) + img.shape[:2]).copy()
    iq = inverse_quant_tables(
        [plan.quant_tables[c.quant_id] for c in plan.components])
    iq = jnp.broadcast_to(jnp.asarray(iq), (batch,) + iq.shape).copy()
    fn = forward_planes_fn(geom, batched=True)
    return batch / device_time(fn, (rgb, iq))


def bench_corpus_route(items, reps=3):
    """frames/s of BatchedCorpusDecoder.decode_all: bytes in, host pixels
    out, transfers included (median of ``reps`` warm runs)."""
    from jpeg_tpu.parallel.pipeline import BatchedCorpusDecoder

    dec = BatchedCorpusDecoder()
    res = dec.decode_all(items)  # warmup and compile
    bad = [r.error for r in res if not r.ok]
    if bad:
        raise RuntimeError(f"corpus route failed: {bad[0]}")
    return median3(lambda: len(items) / _wall(dec.decode_all, items), reps)


def _wall(fn, *args):
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


def main():
    import jax

    enable_compile_cache()
    kind, peaks = require_gpu()
    name = card()
    log(f"device: {jax.devices()[0].platform} {kind} x{len(jax.devices())}; "
        f"card {name}; peaks: {peaks['source']}")

    from jpeg_tpu.io.container import parse_jpeg
    from jpeg_tpu.runtime import (
        native_decode_arith_planes,
        native_decode_lossless,
        native_decode_planes,
        native_decode_progressive,
        pgo_status,
        spec_tuner_snapshot,
    )

    img4k = make_4k_image()
    data = make_4k_jpeg(img4k)
    plan = parse_jpeg(data)
    log(f"4K jpeg: {len(data) / 1e6:.2f} MB, {len(plan.segments)} segments, "
        f"{plan.total_blocks} blocks")

    lib_fps, lib_all_fps = bench_libjpeg(data)
    cpu_unit = median3(bench_cpu_work_unit)
    log(f"libjpeg 1-thread {lib_fps} fps, all-core {lib_all_fps} fps; "
        f"cpu work unit {cpu_unit:.0f} MB/s (host of {name})")

    entropy_fps = median3(lambda: loop_fps(lambda: native_decode_planes(plan),
                                           10))
    corpus_entropy_fps = median3(lambda: corpus_mode(
        lambda _i: native_decode_planes(plan, n_threads=1), 24))
    plan_nr = parse_jpeg(make_4k_jpeg(img4k, restart=False))
    spec_fps = median3(lambda: loop_fps(
        lambda: native_decode_planes(plan_nr), 8))
    tuner = spec_tuner_snapshot()
    spec_chunks = next(
        (st["chosen"] for st in tuner.values() if st["chosen"]), None)
    log(f"entropy 4K: single-image {entropy_fps:.1f} fps, corpus-mode "
        f"{corpus_entropy_fps:.1f} fps, no-restart speculative "
        f"{spec_fps:.1f} fps (chunks={spec_chunks}, pgo={pgo_status()})")

    from jpeg_tpu.entropy.lossless import encode_lossless
    from jpeg_tpu.models.encoder import encode_rgb, encode_rgb_progressive

    rng = np.random.default_rng(3)
    lplan = parse_jpeg(encode_lossless(
        rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8), predictor=4,
        restart_interval=1920))
    lossless_fps = median3(lambda: loop_fps(
        lambda: native_decode_lossless(lplan), 6))
    aplan = parse_jpeg(make_4k_jpeg(img4k, arithmetic=True))
    arith_fps = median3(lambda: loop_fps(
        lambda: native_decode_arith_planes(aplan), 8))
    arith_corpus_fps = median3(lambda: corpus_mode(
        lambda _i: native_decode_arith_planes(aplan, n_threads=1)))
    pplan = parse_jpeg(encode_rgb_progressive(img4k, quality=85))
    prog_fps = median3(lambda: loop_fps(
        lambda: native_decode_progressive(pplan, reuse_buffer=True), 4))
    prog_corpus_fps = median3(lambda: corpus_mode(
        lambda _i: native_decode_progressive(pplan, reuse_buffer=True,
                                             n_threads=1)))
    log(f"lossless 1080p {lossless_fps:.1f} fps; arithmetic 4K "
        f"{arith_fps:.1f} fps (corpus {arith_corpus_fps:.1f}); progressive "
        f"4K {prog_fps:.1f} fps (corpus {prog_corpus_fps:.1f})")

    encode_fps = loop_fps(
        lambda: encode_rgb(img4k, quality=85, restart_interval_mcus=16), 4)
    encode_corpus_fps = corpus_mode(lambda _i: encode_rgb(
        img4k, quality=85, restart_interval_mcus=16), 2 * (os.cpu_count() or 1))
    log(f"encode 4K host: single {encode_fps:.2f} fps, corpus-mode "
        f"{encode_corpus_fps:.2f} fps")

    pix_fps, pix_share = bench_pixel_stage(plan, peaks, batch=64)
    pix_approx_fps, _ = bench_pixel_stage(plan, peaks, batch=64,
                                          idct_mode="approx")
    log(f"pixel stage 4K x64: {pix_fps:.1f} fps = {pix_share:.2%} of HBM "
        f"peak; approx IDCT {pix_approx_fps:.1f} fps, on {name}")
    enc_dev_fps = bench_device_encode(img4k, plan)
    log(f"device forward transform 4K x8: {enc_dev_fps:.1f} fps, on {name}")

    from jpeg_tpu.io.corpus import synthetic_image

    f1080 = [encode_rgb(synthetic_image(1920, 1080, i), quality=85,
                  subsampling=(2, 2), restart_interval_mcus=120)
             for i in range(16)]
    p1080 = parse_jpeg(f1080[0])
    c1080_entropy = median3(lambda: corpus_mode(
        lambda _i: native_decode_planes(p1080, n_threads=1), 48))
    c1080_dev, _ = bench_pixel_stage(p1080, peaks, batch=256)
    c1080_fps = bench_corpus_route([f1080[i % 16] for i in range(256)])
    log(f"1080p: entropy corpus-mode {c1080_entropy:.1f} fps, pixel stage "
        f"x256 {c1080_dev:.1f} fps, corpus route x256 {c1080_fps:.2f} fps, "
        f"on {name}")

    f4k = [data] + [make_4k_jpeg(make_4k_image(seed)) for seed in range(1, 8)]
    e2e_fps = bench_corpus_route([f4k[i % 8] for i in range(64)])
    log(f"4K corpus route x64: {e2e_fps:.2f} fps, on {name}")

    devs = jax.devices()
    detail = {
        "device": {"platform": devs[0].platform, "kind": kind,
                   "count": len(devs)},
        "card": name,
        "peaks_source": peaks["source"],
        "entropy_host_fps": round(entropy_fps, 2),
        "entropy_corpus_fps": round(corpus_entropy_fps, 2),
        "entropy_speculative_norestart_fps": round(spec_fps, 2),
        "progressive_4k_entropy_fps": round(prog_fps, 2),
        "progressive_4k_corpus_fps": round(prog_corpus_fps, 2),
        "arithmetic_4k_entropy_fps": round(arith_fps, 2),
        "arithmetic_4k_corpus_fps": round(arith_corpus_fps, 2),
        "lossless_1080p_fps": round(lossless_fps, 2),
        "libjpeg_1thread_fps": lib_fps and round(lib_fps, 2),
        "libjpeg_allcore_fps": lib_all_fps and round(lib_all_fps, 2),
        "cpu_work_unit_mb_s": round(cpu_unit, 1),
        "host_cores": os.cpu_count(),
        "encode_4k_fps": round(encode_fps, 2),
        "encode_4k_corpus_fps": round(encode_corpus_fps, 2),
        "encode_4k_device_transform_fps": round(enc_dev_fps, 2),
        "device_pipeline_fps": round(pix_fps, 2),
        "device_pipeline_hbm_share": round(pix_share, 4),
        "device_pipeline_approx_fps": round(pix_approx_fps, 2),
        "corpus_1080p_entropy_fps": round(c1080_entropy, 2),
        "corpus_1080p_device_fps": round(c1080_dev, 2),
        "corpus_1080p_route_fps": round(c1080_fps, 2),
        "spec_chunks": spec_chunks,
        "spec_tuner": tuner,
        "pgo": pgo_status(),
    }
    print(json.dumps({
        "metric": "frames_per_s_4k_corpus_route",
        "value": round(e2e_fps, 2),
        "unit": "frames/s",
        "vs_baseline": lib_fps and round(e2e_fps / lib_fps, 2),
        "vs_libjpeg_allcore": lib_all_fps and round(e2e_fps / lib_all_fps, 2),
        "detail": detail,
    }))


if __name__ == "__main__":
    main()
