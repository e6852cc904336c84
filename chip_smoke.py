"""Smoke test of the decode engine on one NVIDIA GPU, through its entry points.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --cards 4    # the four-card data-parallel path only

Everything runs in this one process: a second JAX process on the card would
fail for want of device memory, so the CLI is called in-process.

Phases (one card):
1. environment: devices, JAX version, card name and power limit, the native
   C++ runtime and its build key; fails unless the backend is ``gpu``;
2. compile-only: the pixel stage at 4K x64 and 1080p x256, with
   ``compiled.memory_analysis()``;
3. correctness at real widths, seeded corpora made by the repo's encoder:
   compat on the GPU vs compat on this process's CPU backend, the plane path
   vs compat, ``BatchedCorpusDecoder`` vs the per-image plane path, the
   approx IDCT vs exact, and the device encoder vs the host encoder;
4. ``python -m jpeg_tpu corpus --batched`` on 64 4K and 256 1080p frames;
5. timings (informative): the corpus route's frames/s, the pixel stage
   alone for compat and for the plane path.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Any failed phase raises, so that line is never printed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jpeg_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

SEED = 0
UHD, FHD = (3840, 2160), (1920, 1080)
QHD = (2560, 1440)  # full MCU rows and an even MCU-row count (rows_sp)
N_UHD, N_FHD = 64, 256
TOL_U8 = 1  # cuBLAS sums in another order than the CPU backend


def card() -> str:
    """``name, power.limit`` of the card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def stream(size, seed, quality=85, subsampling=(2, 2), gray=False):
    """One seeded JPEG with one restart interval per MCU row."""
    from jpeg_tpu.io.corpus import synthetic_image
    from jpeg_tpu.models.encoder import encode_rgb

    w, h = size
    img = synthetic_image(w, h, seed)
    if gray:
        img, subsampling = img[..., 0], (1, 1)
    mcu_w = 8 * subsampling[0]
    return encode_rgb(img, quality=quality, subsampling=subsampling,
                      restart_interval_mcus=-(-w // mcu_w))


def compare(name, got, want, tol=TOL_U8):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"  {name}: shape {got.shape} max|diff| {int(d.max())} "
          f"differing {int((d > 0).sum())} tol {tol}", flush=True)
    if d.max() > tol:
        raise AssertionError(f"{name}: max |diff| {int(d.max())} > {tol}")


def psnr(a, b) -> float:
    mse = float(((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean())
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def timed(fn, reps):
    """Median wall seconds of ``fn()`` (which blocks until ready)."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def phase_environment():
    from jpeg_tpu import runtime

    devs = jax.devices()
    print(f"[env] jax {jax.__version__} backend {jax.default_backend()} "
          f"devices {devs} kind {devs[0].device_kind}", flush=True)
    if jax.default_backend() != "gpu":
        raise SystemExit(f"no GPU: default backend is {jax.default_backend()}")
    print(f"[env] card: {card()}", flush=True)
    runtime._load()  # raises if the native library does not build or load
    print(f"[env] native runtime loaded, build key {runtime.build_key()}, "
          f"pgo {runtime.pgo_status()}", flush=True)
    print(f"[env] compile cache {enable_compile_cache()}", flush=True)


def plane_inputs(data, batch):
    """(geometry, device planes [B, ...] per component, q [B, ncomp, 8, 8])
    for ``batch`` copies of one stream."""
    from jpeg_tpu.io.container import parse_jpeg
    from jpeg_tpu.models.decoder import PipelineGeometry
    from jpeg_tpu.ops.pixel import plan_quant_tables
    from jpeg_tpu.runtime import native_decode_planes

    plan = parse_jpeg(data)
    planes = [jnp.broadcast_to(jnp.asarray(p), (batch,) + p.shape).copy()
              for p in native_decode_planes(plan)]
    q = jnp.broadcast_to(jnp.asarray(plan_quant_tables(plan)),
                         (batch, len(planes), 8, 8)).copy()
    return PipelineGeometry.of(plan), planes, q


def phase_compile(streams):
    from jpeg_tpu.ops.pixel import planes_to_rgb_fn

    for label, data, batch in streams:
        geom, planes, q = plane_inputs(data, batch)
        spec = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                            (planes, q))
        t0 = time.perf_counter()
        compiled = planes_to_rgb_fn(geom, batched=True).lower(*spec).compile()
        print(f"[compile] pixel stage {label} x{batch}: "
              f"{time.perf_counter() - t0:.2f} s, memory_analysis: "
              f"{compiled.memory_analysis()}", flush=True)


def phase_correctness(uhd, fhd):
    from jpeg_tpu.io.container import parse_jpeg
    from jpeg_tpu.models.decoder import decode_bytes, decode_plan
    from jpeg_tpu.parallel.pipeline import BatchedCorpusDecoder

    cpu = jax.devices("cpu")[0]
    for label, data in (("4K", uhd[0]), ("1080p", fhd[0])):
        plan = parse_jpeg(data)
        gpu = np.asarray(decode_plan(plan))
        with jax.default_device(cpu):
            ref = np.asarray(decode_plan(plan))
        compare(f"[correct] compat GPU vs compat CPU {label}", gpu, ref)
        compare(f"[correct] plane path vs compat {label}",
                decode_bytes(data, path="fast"), gpu)

    # Mixed samplings at 1080p through the plane path.
    for label, kw in (("4:2:2", dict(subsampling=(2, 1))),
                      ("4:4:4", dict(subsampling=(1, 1))),
                      ("gray", dict(gray=True))):
        data = stream(FHD, SEED + 1, **kw)
        compare(f"[correct] plane path vs compat 1080p {label}",
                decode_bytes(data, path="fast"), decode_bytes(data))

    distinct = uhd[:8]
    dec = BatchedCorpusDecoder()
    results = dec.decode_all(distinct)
    for i, (data, r) in enumerate(zip(distinct, results)):
        if not r.ok:
            raise AssertionError(f"batched decode failed: {r.error}")
        compare(f"[correct] BatchedCorpusDecoder vs per-image 4K #{i}",
                r.rgb, decode_bytes(data, path="fast"))

    for label, data in approx_matrix(uhd[0], fhd[0]):
        plan = parse_jpeg(data)
        from jpeg_tpu.models.decoder import decode_plan_fast

        exact = np.asarray(decode_plan_fast(plan))
        approx = np.asarray(decode_plan_fast(plan, idct_mode="approx"))
        d = np.abs(exact.astype(np.int32) - approx.astype(np.int32))
        print(f"  [approx] {label} {plan.width}x{plan.height}: "
              f"max|diff| {int(d.max())} PSNR {psnr(exact, approx):.2f} dB "
              f"vs exact", flush=True)

    check_device_encoder()


def approx_matrix(uhd0, fhd0):
    yield "4K q85 4:2:0", uhd0
    for q in (70, 95):
        yield f"4K q{q} 4:2:0", stream(UHD, SEED, quality=q)
    yield "1080p q85 4:2:0", fhd0
    yield "1080p q90 gray", stream(FHD, SEED, quality=90, gray=True)
    yield "1080p q92 4:4:4", stream(FHD, SEED, quality=92, subsampling=(1, 1))


def check_device_encoder():
    """encode_rgb_device (forward transform on the GPU) vs the host
    encoder: both streams decode, and the quantized coefficients differ by
    at most one step."""
    from jpeg_tpu.io.container import parse_jpeg
    from jpeg_tpu.io.corpus import synthetic_image
    from jpeg_tpu.models.decoder import decode_bytes
    from jpeg_tpu.models.encoder import encode_rgb, encode_rgb_device
    from jpeg_tpu.runtime import native_decode_planes

    img = synthetic_image(*UHD, SEED)
    kw = dict(quality=85, subsampling=(2, 2), restart_interval_mcus=240)
    host, dev = encode_rgb(img, **kw), encode_rgb_device(img, **kw)
    planes = [[p.copy() for p in native_decode_planes(parse_jpeg(d))]
              for d in (host, dev)]
    worst = max(int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())
                for a, b in zip(*planes))
    print(f"  [correct] encode_rgb_device vs encode_rgb 4K: coefficient "
          f"max|diff| {worst} steps (tol 1), PSNR device-encoded "
          f"{psnr(decode_bytes(dev), img):.2f} dB, host-encoded "
          f"{psnr(decode_bytes(host), img):.2f} dB", flush=True)
    if worst > 1:
        raise AssertionError(f"device encoder: {worst} quantization steps")


def write_corpus(directory, streams, n):
    os.makedirs(directory)
    for i in range(n):
        with open(os.path.join(directory, f"img_{i:05d}.jpg"), "wb") as f:
            f.write(streams[i % len(streams)])


def run_cli(argv):
    from jpeg_tpu.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0:
        raise AssertionError(f"cli {argv} exited {rc}")
    return report


def phase_main_path(tmp, uhd, fhd, name):
    rates = {}
    for label, streams, n in (("4K", uhd, N_UHD), ("1080p", fhd, N_FHD)):
        directory = os.path.join(tmp, label)
        write_corpus(directory, streams, n)
        report = run_cli(["corpus", directory, "--batched", "--manifest",
                          os.path.join(tmp, f"manifest_{label}")])
        print(f"[main] corpus --batched {label} x{n}: decoded "
              f"{report['decoded']} failed {report['failed']} (first run, "
              f"compile included: {report['wall_s']} s)", flush=True)
        if report["decoded"] != n or report["failed"]:
            raise AssertionError(f"corpus {label}: {report}")
        warm = run_cli(["corpus", directory, "--batched"])
        rates[label] = warm["frames_per_s"]
        print(f"[time] corpus --batched {label} x{n}: "
              f"{warm['frames_per_s']} frames/s ({warm['wall_s']} s) "
              f"on {name}", flush=True)
        route_breakdown(label, [streams[i % len(streams)] for i in range(n)],
                        name)
    return rates


def route_breakdown(label, items, name):
    """Host entropy alone vs the whole BatchedCorpusDecoder.decode_all."""
    from jpeg_tpu.parallel.pipeline import BatchedCorpusDecoder

    dec = BatchedCorpusDecoder()
    dec.decode_all(items)
    t0 = time.perf_counter()
    list(dec._get_pool().map(dec._entropy_one, items))
    t_entropy = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec.decode_all(items)
    t_all = time.perf_counter() - t0
    n = len(items)
    print(f"[time] route breakdown {label} x{n}: host entropy alone "
          f"{n / t_entropy:.2f} frames/s ({t_entropy:.3f} s), decode_all "
          f"{n / t_all:.2f} frames/s ({t_all:.3f} s); {dec.workers} workers, "
          f"os.cpu_count {os.cpu_count()}, usable cores "
          f"{len(os.sched_getaffinity(0))}, on {name}", flush=True)


def phase_pixel_timing(uhd0, fhd0, name):
    from jpeg_tpu.io.container import parse_jpeg
    from jpeg_tpu.models.decoder import PipelineGeometry, plan_matrices
    from jpeg_tpu.ops.pixel import planes_to_rgb_fn
    from jpeg_tpu.parallel.batch import decode_batch
    from jpeg_tpu.runtime import native_decode_coefficients

    for label, data, batch in (("4K", uhd0, N_UHD), ("1080p", fhd0, N_FHD)):
        geom, planes, q = plane_inputs(data, batch)
        fn = planes_to_rgb_fn(geom, batched=True)
        t = timed(lambda: fn(planes, q).block_until_ready(), 5)
        print(f"[time] pixel stage plane {label} x{batch}: {t * 1e3:.3f} ms "
              f"= {batch / t:.1f} frames/s on {name}", flush=True)
        del planes

        plan = parse_jpeg(data)
        coeffs = jnp.asarray(native_decode_coefficients(plan))
        coeffs = jnp.broadcast_to(coeffs, (batch,) + coeffs.shape).copy()
        mats = jnp.broadcast_to(jnp.asarray(plan_matrices(plan)),
                                (batch, len(plan.components), 64, 64)).copy()
        geom = PipelineGeometry.of(plan)
        t = timed(lambda: decode_batch(coeffs, mats, geom).block_until_ready(),
                  5)
        print(f"[time] pixel stage compat {label} x{batch}: {t * 1e3:.3f} ms "
              f"= {batch / t:.1f} frames/s on {name}", flush=True)
        del coeffs, mats


def one_card():
    phase_environment()
    name = card()
    t0 = time.perf_counter()
    uhd = [stream(UHD, SEED + i) for i in range(8)]
    fhd = [stream(FHD, SEED + i) for i in range(16)]
    print(f"[corpus] 8 distinct 4K and 16 distinct 1080p streams in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    phase_compile([("4K", uhd[0], N_UHD), ("1080p", fhd[0], N_FHD)])
    phase_correctness(uhd, fhd)
    with tempfile.TemporaryDirectory() as tmp:
        phase_main_path(tmp, uhd, fhd, name)
    phase_pixel_timing(uhd[0], fhd[0], name)


def four_cards(devs):
    """BatchedCorpusDecoder over a 4-card data mesh and decode_batch_rows_sp
    over (2 data x 2 seg), each against the same frames on one card."""
    from jax.sharding import Mesh

    from jpeg_tpu.io.container import parse_jpeg
    from jpeg_tpu.models.decoder import PipelineGeometry, plan_matrices
    from jpeg_tpu.ops.pixel import plan_quant_tables
    from jpeg_tpu.parallel.batch import (
        decode_batch,
        decode_batch_fast,
        decode_batch_rows_sp,
    )
    from jpeg_tpu.parallel.mesh import make_mesh
    from jpeg_tpu.parallel.pipeline import BatchedCorpusDecoder
    from jpeg_tpu.runtime import native_decode_coefficients, native_decode_planes

    if len(devs) < 4:
        raise SystemExit(f"--cards 4 needs 4 devices, found {len(devs)}")
    mesh = make_mesh(devices=devs[:4])
    frames = [stream(FHD, SEED + i) for i in range(16)]
    sharded = BatchedCorpusDecoder(mesh=mesh).decode_all(frames)
    single = BatchedCorpusDecoder().decode_all(frames)
    for i, (a, b) in enumerate(zip(sharded, single)):
        if not (a.ok and b.ok):
            raise AssertionError(f"frame {i}: {a.error or b.error}")
        compare(f"[4 cards] BatchedCorpusDecoder mesh vs one card #{i}",
                a.rgb, b.rgb)

    plans = [parse_jpeg(f) for f in frames]
    geom = PipelineGeometry.of(plans[0])
    bp = [np.stack([native_decode_planes(p)[c].copy() for p in plans])
          for c in range(3)]
    bq = np.stack([plan_quant_tables(p) for p in plans])
    out = decode_batch_fast(bp, bq, geom, mesh=mesh)
    placed = {s.device for s in out.addressable_shards}
    print(f"  [4 cards] data-mesh output shards on {len(placed)} devices: "
          f"{sorted(str(d) for d in placed)}", flush=True)
    if len(placed) != 4:
        raise AssertionError(f"shards on {len(placed)} devices, want 4")

    qhd = [stream(QHD, SEED + i) for i in range(4)]
    qplans = [parse_jpeg(d) for d in qhd]
    qgeom = PipelineGeometry.of(qplans[0])
    coeffs = np.stack([native_decode_coefficients(p).copy() for p in qplans])
    mats = np.stack([plan_matrices(p) for p in qplans])
    mesh2 = Mesh(np.array(devs[:4]).reshape(2, 2), ("data", "seg"))
    rgb, frames_seen = decode_batch_rows_sp(coeffs, mats, qgeom, mesh2)
    placed = {s.device for s in rgb.addressable_shards}
    print(f"  [4 cards] rows_sp (2 data x 2 seg) shards on {len(placed)} "
          f"devices, frames {int(frames_seen)}", flush=True)
    if len(placed) != 4 or int(frames_seen) != len(qhd):
        raise AssertionError("rows_sp placement or frame count")
    with jax.default_device(devs[0]):
        want = decode_batch(coeffs, mats, qgeom)
    compare("[4 cards] decode_batch_rows_sp vs one card", rgb, want)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = p.parse_args()
    enable_compile_cache()
    if args.cards == 4:
        phase_environment()
        four_cards(jax.devices())
    else:
        one_card()
    devs = jax.devices()
    print(f"card: {card()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
