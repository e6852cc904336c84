"""Command-line interface.

Parity: reference CLI ``src/main.rs:24-40`` (``decode <in.jpeg> <out.ppm>``)
plus the subcommands this engine adds: encode, corpus decode with
resume manifest, and visual diff (the reference Makefile's eyeball loop,
``Makefile:4-7``, automated).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def cmd_decode(args) -> int:
    from jpeg_tpu.io.ppm import write_ppm
    from jpeg_tpu.models.decoder import decode_file

    if args.path == "fast":
        from jpeg_tpu.io.container import parse_jpeg
        from jpeg_tpu.models.decoder import decode_plan_fast
        import numpy as np

        with open(args.input, "rb") as f:
            plan = parse_jpeg(f.read())
        rgb = np.asarray(decode_plan_fast(plan, rounding=args.rounding,
                                          idct_mode=args.idct))
    else:
        from jpeg_tpu.io.container import parse_jpeg as _parse
        from jpeg_tpu.models.decoder import decode_plan as _dp
        import numpy as _np

        with open(args.input, "rb") as f:
            plan = _parse(f.read())
        rgb = _np.asarray(_dp(plan, rounding=args.rounding,
                              engine=args.engine, upsample=args.upsample))
        if args.exif_orientation:
            from jpeg_tpu.models.decoder import apply_exif_orientation

            rgb = apply_exif_orientation(
                rgb, (plan.exif or {}).get("orientation"))
    write_ppm(args.output, rgb, binary=not args.p3)
    print(f"{args.input}: {rgb.shape[1]}x{rgb.shape[0]} -> {args.output}")
    return 0


def cmd_encode(args) -> int:
    import numpy as np
    from PIL import Image

    from jpeg_tpu.models.encoder import encode_rgb

    if args.color in ("cmyk", "ycck"):
        from jpeg_tpu.models.encoder import encode_cmyk

        cmyk = np.asarray(Image.open(args.input).convert("CMYK"))
        data = encode_cmyk(cmyk, quality=args.quality,
                           restart_interval_mcus=args.restart_interval,
                           ycck=args.color == "ycck")
        with open(args.output, "wb") as f:
            f.write(data)
        print(f"{args.input} -> {args.output} ({len(data)} bytes)")
        return 0
    if args.precision == 12 and args.input.endswith(".ppm"):
        # 12-bit sources come in as 16-bit PPM (PIL has no 12-bit JPEG).
        from jpeg_tpu.io.ppm import read_ppm

        img, maxval = read_ppm(args.input, return_maxval=True)
        if img.dtype == np.uint8:
            img = img.astype(np.uint16) << 4  # promote 8-bit PPM
        elif maxval != 4095:
            # A maxval-65535 PPM would feed samples past the 12-bit
            # level shift (2048) / category caps: corrupt stream.
            raise SystemExit(
                f"--precision 12 needs a maxval-4095 (or 8-bit) PPM; "
                f"{args.input} has maxval {maxval}")
    else:
        img = np.asarray(Image.open(args.input).convert("RGB"))
        if args.precision == 12:
            img = img.astype(np.uint16) << 4  # promote 8-bit sources
    sub = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}[args.subsampling]
    if getattr(args, "lossless", False):
        from jpeg_tpu.entropy.lossless import encode_lossless

        data = encode_lossless(img, predictor=args.predictor,
                               precision=args.precision,
                               restart_interval=args.restart_interval)
        with open(args.output, "wb") as f:
            f.write(data)
        print(f"{args.input} -> {args.output} ({len(data)} bytes, lossless)")
        return 0
    if args.progressive:
        from jpeg_tpu.models.encoder import encode_rgb_progressive

        data = encode_rgb_progressive(img, quality=args.quality,
                                      subsampling=sub,
                                      arithmetic=args.arithmetic,
                                      precision=args.precision)
    else:
        data = encode_rgb(img, quality=args.quality, subsampling=sub,
                          restart_interval_mcus=args.restart_interval,
                          optimize=args.optimize,
                          arithmetic=args.arithmetic,
                          precision=args.precision)
    with open(args.output, "wb") as f:
        f.write(data)
    print(f"{args.input} -> {args.output} ({len(data)} bytes)")
    return 0


def cmd_corpus(args) -> int:
    """Decode a corpus directory with resume manifest + JSON metrics."""
    from jpeg_tpu.io.corpus import list_corpus, shard_items
    from jpeg_tpu.models.decoder import decode_file
    from jpeg_tpu.utils.manifest import Manifest
    from jpeg_tpu.utils.profiling import StageTimer

    if args.distributed:
        # Multi-host run: jax.distributed supplies this process's shard
        # index (BASELINE config 5; the static --process-index/--count
        # flags are ignored in this mode).
        from jpeg_tpu.parallel.distributed import initialize

        args.process_index, args.process_count = initialize()
    paths = list_corpus(args.directory)
    paths = shard_items(paths, args.process_index, args.process_count)
    manifest = Manifest(args.manifest, args.process_index) if args.manifest else None
    if manifest:
        paths = manifest.pending(paths)
    if args.limit:
        # Bounded invocation for process recycling: decode at most N
        # pending images then exit 0; rerunning with the same manifest
        # continues.
        paths = paths[: args.limit]
    timer = StageTimer()
    done = failed = 0
    t0 = time.perf_counter()
    if args.batched:
        from jpeg_tpu.parallel.pipeline import BatchedCorpusDecoder

        # Chunked: the manifest checkpoints after every chunk, so a
        # crash mid-corpus loses at most chunk_size images' work. Chunks
        # stay large enough to keep the batched pixel stage fed.
        dec = BatchedCorpusDecoder(rounding=args.rounding,
                                   idct_mode=args.idct)
        chunk = max(1, args.chunk_size)
        for c0 in range(0, len(paths), chunk):
            part = paths[c0 : c0 + chunk]
            with timer.stage("decode", frames=len(part)):
                results = dec.decode_all(part)
            for p, r in zip(part, results):
                if r.ok:
                    done += 1
                    if manifest:
                        manifest.mark_done(p, h=int(r.rgb.shape[0]),
                                           w=int(r.rgb.shape[1]))
                else:
                    failed += 1
                    print(f"FAILED {p}: {r.error}", file=sys.stderr)
    else:
        for p in paths:
            try:
                with timer.stage("decode", frames=1):
                    rgb = decode_file(p, rounding=args.rounding,
                                      engine=args.engine)
                done += 1
                if manifest:
                    manifest.mark_done(p, h=int(rgb.shape[0]),
                                       w=int(rgb.shape[1]))
            except Exception as e:  # per-image error isolation (SURVEY.md §5)
                failed += 1
                print(f"FAILED {p}: {e}", file=sys.stderr)
    wall = time.perf_counter() - t0
    report = {
        "decoded": done,
        "failed": failed,
        "wall_s": round(wall, 3),
        "frames_per_s": round(done / wall, 2) if wall > 0 else None,
        "process_index": args.process_index,
        "stages": timer.report(),
    }
    if args.distributed:
        # Cross-host totals: every host reports the same aggregate block
        # (sum of frames and of per-host rates) plus its local numbers.
        from jpeg_tpu.parallel.distributed import aggregate_metrics

        report["aggregate"] = aggregate_metrics({
            "decoded": float(done),
            "failed": float(failed),
            "frames_per_s": done / wall if wall > 0 else 0.0,
        })
        report["process_count"] = args.process_count
    print(json.dumps(report))
    return 1 if failed and args.strict else 0


def cmd_info(args) -> int:
    """Print stream metadata as JSON (the reference left this as a TODO,
    src/jpeg/mod.rs:350-352: "might be useful if we want to print info")."""
    from jpeg_tpu.io.container import parse_jpeg

    with open(args.input, "rb") as f:
        plan = parse_jpeg(f.read())
    print(json.dumps({
        "width": plan.width,
        "height": plan.height,
        "components": [
            {"id": c.component_id, "sampling": [c.h, c.v],
             "quant_table": c.quant_id, "dc_table": c.dc_id,
             "ac_table": c.ac_id}
            for c in plan.components
        ],
        "color_model": plan.color_model,
        "progressive": plan.progressive,
        "arithmetic": plan.arith_code,
        "precision": plan.precision,
        "lossless": plan.lossless,
        "predictor": plan.predictor or None,
        "point_transform": plan.point_transform or None,
        "mcus": [plan.mcus_x, plan.mcus_y],
        "restart_interval_mcus": plan.restart_interval,
        "entropy_segments": len(plan.segments),
        "entropy_bytes": int(plan.scan_data.size),
        "jfif_version": plan.jfif_version,
        "jfif_density": plan.jfif_density,
        "comment": plan.comment,
        "exif": plan.exif,
    }))
    return 0


def cmd_diff(args) -> int:
    """Decode + compare against PIL/libjpeg; print PSNR (Makefile:4-7 role)."""
    import numpy as np
    from PIL import Image

    from jpeg_tpu.models.decoder import decode_file

    with open(args.input, "rb") as f:
        from jpeg_tpu.io.container import parse_jpeg as _parse
        from jpeg_tpu.models.decoder import decode_plan as _dp

        ours = np.asarray(_dp(_parse(f.read()), rounding=args.rounding,
                              upsample=args.upsample))
    pil = np.asarray(Image.open(args.input).convert("RGB"))
    mse = ((ours.astype(np.float64) - pil.astype(np.float64)) ** 2).mean()
    psnr = float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)
    print(json.dumps({
        "input": args.input,
        "shape": list(ours.shape),
        "psnr_vs_libjpeg_db": round(psnr, 2),
        "max_abs_diff": int(np.abs(ours.astype(int) - pil.astype(int)).max()),
    }))
    if args.diff_output:
        diff = np.abs(ours.astype(int) - pil.astype(int))
        amplified = np.clip(diff * args.amplify, 0, 255).astype(np.uint8)
        Image.fromarray(amplified).save(args.diff_output)
    return 0


def main(argv=None) -> int:
    from jpeg_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser(prog="jpeg_tpu",
                                description="JPEG engine (JAX + C++)")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("decode", help="decode JPEG to PPM (reference CLI parity)")
    d.add_argument("input")
    d.add_argument("output")
    d.add_argument("--rounding", choices=["truncate", "round"], default="truncate")
    d.add_argument("--engine", choices=["auto", "native", "oracle"], default="auto")
    d.add_argument("--idct", choices=["exact", "approx"], default="exact",
                   help="approx = DEFAULT-precision IDCT in the fast path "
                        "(TF32 on a GPU; measured error in "
                        "docs/APPROX_QUALITY.md)")
    d.add_argument("--path", choices=["compat", "fast"], default="compat",
                   help="fast = plane pipeline (within 1 u8 of compat)")
    d.add_argument("--upsample", choices=["replicate", "fancy"],
                   default="replicate",
                   help="fancy = libjpeg-style triangular chroma filter")
    d.add_argument("--exif-orientation", action="store_true",
                   help="apply the EXIF orientation tag")
    d.add_argument("--p3", action="store_true",
                   help="ASCII P3 output (reference main.rs format); default P6")
    d.set_defaults(fn=cmd_decode)

    e = sub.add_parser("encode", help="encode image to baseline JPEG")
    e.add_argument("input")
    e.add_argument("output")
    e.add_argument("--quality", type=int, default=85)
    e.add_argument("--subsampling", choices=["444", "422", "420"], default="420")
    e.add_argument("--restart-interval", type=int, default=0,
                   help="MCUs per restart segment (0 = none)")
    e.add_argument("--optimize", action="store_true",
                   help="per-image optimal Huffman tables (Annex K.2)")
    e.add_argument("--precision", type=int, choices=[8, 12], default=8,
                   help="sample precision; 12 emits SOF1/SOF9/SOF2/SOF10 "
                        "extended streams (16-bit PPM input, or 8-bit "
                        "sources promoted x16)")
    e.add_argument("--arithmetic", action="store_true",
                   help="QM arithmetic entropy coding (SOF9/SOF10)")
    e.add_argument("--lossless", action="store_true",
                   help="SOF3 lossless (T.81 Annex H); samples stored "
                        "exactly, decoded bit-identically")
    e.add_argument("--predictor", type=int, choices=range(1, 8), default=1,
                   help="lossless predictor selection (T.81 H.1.2.1)")
    e.add_argument("--progressive", action="store_true",
                   help="progressive (SOF2) output, standard scan script")
    e.add_argument("--color", choices=["auto", "cmyk", "ycck"], default="auto",
                   help="cmyk/ycck = 4-component Adobe APP14 output")
    e.set_defaults(fn=cmd_encode)

    c = sub.add_parser("corpus", help="decode a corpus directory (resumable)")
    c.add_argument("directory")
    c.add_argument("--manifest", default=None, help="resume manifest path stem")
    c.add_argument("--rounding", choices=["truncate", "round"], default="truncate")
    c.add_argument("--engine", choices=["auto", "native", "oracle"], default="auto")
    c.add_argument("--process-index", type=int, default=0)
    c.add_argument("--process-count", type=int, default=1)
    c.add_argument("--strict", action="store_true", help="exit 1 on any failure")
    c.add_argument("--idct", choices=["exact", "approx"], default="exact",
                   help="approx IDCT tier for the batched pixel stage "
                        "(docs/APPROX_QUALITY.md)")
    c.add_argument("--limit", type=int, default=0,
                   help="decode at most N pending images this invocation "
                        "then exit (process recycling; combine with "
                        "--manifest)")
    c.add_argument("--chunk-size", type=int, default=64,
                   help="batched mode: images per decode_all chunk; the "
                        "manifest checkpoints after every chunk (crash "
                        "loses at most one chunk)")
    c.add_argument("--batched", action="store_true",
                   help="geometry-bucketed batch decode (plane path)")
    c.add_argument("--distributed", action="store_true",
                   help="multi-host mode: shard via jax.distributed "
                        "(JAX_COORDINATOR_ADDRESS/_NUM_PROCESSES/"
                        "_PROCESS_ID) and aggregate metrics across hosts")
    c.set_defaults(fn=cmd_corpus)

    i = sub.add_parser("info", help="print stream metadata as JSON")
    i.add_argument("input")
    i.set_defaults(fn=cmd_info)

    f = sub.add_parser("diff", help="PSNR vs libjpeg (visual-diff harness)")
    f.add_argument("input")
    f.add_argument("--rounding", choices=["truncate", "round"], default="round")
    f.add_argument("--upsample", choices=["replicate", "fancy"],
                   default="replicate")
    f.add_argument("--diff-output", default=None)
    f.add_argument("--amplify", type=int, default=16)
    f.set_defaults(fn=cmd_diff)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
