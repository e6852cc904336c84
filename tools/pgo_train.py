"""PGO training driver for the native decode runtime.

Invoked by the Makefile's profile-guided build phase with the path to
the INSTRUMENTED libjpegtpu build: decodes representative synthetic
streams (4:2:0 restart, no-restart speculative, grayscale) through it
so gcc's -fprofile-use rebuild learns the hot symbol-kind branch mix.
Measured +6-10% on the corpus entropy rate (4-core x86 host).

Must not trigger the runtime's own build (that is who invoked us).
"""

import ctypes
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    so_path = sys.argv[1]
    import jpeg_tpu.runtime as rt

    lib = ctypes.CDLL(os.path.abspath(so_path))
    rt._configure(lib)
    rt._lib = lib  # pre-seed so _load() never starts a build
    # The encoder library is built first, into the same directory.
    enc = ctypes.CDLL(os.path.join(os.path.dirname(os.path.abspath(so_path)),
                                   "libjpegtpu_enc.so"))
    rt._configure_enc(enc)
    rt._enc_lib = enc

    import numpy as np

    from jpeg_tpu.io.container import parse_jpeg
    from jpeg_tpu.models.encoder import encode_rgb
    from jpeg_tpu.runtime import native_decode_planes

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
    # Smooth half so EOB/pair-hit branch mixes match real content too.
    img[:, :960] = img[:, 960:961]
    streams = [
        encode_rgb(img, quality=85, subsampling=(2, 2),
                   restart_interval_mcus=120),
        encode_rgb(img, quality=85, subsampling=(2, 2)),
        encode_rgb(img[..., 0], quality=85),
    ]
    try:
        # libjpeg-encoded stream: most real-world JPEGs carry libjpeg's
        # table conventions, whose symbol/branch mix differs from our
        # encoder's — train on both.
        import io

        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=85,
                                  restart_marker_rows=1)
        streams.append(buf.getvalue())
    except ImportError:
        pass
    for data in streams:
        plan = parse_jpeg(data)
        for _ in range(3):
            native_decode_planes(plan)

    # Arithmetic (QM) and progressive paths live in the same library —
    # train their branch mixes too.
    from jpeg_tpu.runtime import (
        native_decode_arith_planes,
        native_decode_progressive,
    )

    ad = encode_rgb(img[:512, :512], quality=85, arithmetic=True,
                    restart_interval_mcus=8)
    aplan = parse_jpeg(ad)
    for _ in range(3):
        native_decode_arith_planes(aplan)
    try:
        import io

        from PIL import Image

        pb = io.BytesIO()
        Image.fromarray(img[:512, :512]).save(
            pb, "JPEG", quality=85, progressive=True)
        pplan = parse_jpeg(pb.getvalue())
        for _ in range(3):
            native_decode_progressive(pplan, reuse_buffer=True)
    except ImportError:
        pass


if __name__ == "__main__":
    main()
