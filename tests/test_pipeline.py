"""Pipelined corpus decoder + distributed helpers tests."""

import numpy as np

from jpeg_tpu.io.corpus import synthetic_jpeg
from jpeg_tpu.models.decoder import decode_bytes
from jpeg_tpu.parallel.distributed import (
    aggregate_metrics,
    initialize,
    scaling_efficiency,
)
from jpeg_tpu.parallel.pipeline import CorpusDecoder


def test_corpus_decoder_matches_single():
    items = [synthetic_jpeg(96, 64, seed=i, quality=88) for i in range(6)]
    dec = CorpusDecoder(workers=3)
    results = dec.decode_all(items)
    assert all(r.ok for r in results)
    for data, r in zip(items, results):
        np.testing.assert_array_equal(r.rgb, decode_bytes(data))


def test_corpus_decoder_error_isolation():
    items = [synthetic_jpeg(64, 48, seed=1), b"\xff\xd8 not a jpeg",
             synthetic_jpeg(64, 48, seed=2)]
    results = CorpusDecoder(workers=2).decode_all(items)
    assert results[0].ok and results[2].ok
    assert not results[1].ok and "JPEGError" in results[1].error


def test_corpus_decoder_fast_path():
    items = [synthetic_jpeg(96, 64, seed=3)]
    (r,) = CorpusDecoder(workers=1, path="fast").decode_all(items)
    assert r.ok
    compat = decode_bytes(items[0])
    assert np.abs(r.rgb.astype(int) - compat.astype(int)).max() <= 1


def test_distributed_single_process():
    idx, count = initialize()
    assert (idx, count) == (0, 1)
    m = aggregate_metrics({"frames": 7.0, "bytes": 100.0})
    assert m == {"frames": 7.0, "bytes": 100.0}
    assert scaling_efficiency(160.0, 2, 100.0) == 0.8
    assert scaling_efficiency(0, 0, 0) == 0.0


def test_batched_corpus_decoder_buckets():
    """Mixed-geometry corpus: bucketed batch decode matches single decode."""
    from jpeg_tpu.parallel.pipeline import BatchedCorpusDecoder

    items = (
        [synthetic_jpeg(96, 64, seed=i) for i in range(3)]      # bucket A
        + [synthetic_jpeg(128, 96, seed=i) for i in range(2)]   # bucket B
        + [b"\xff\xd8 broken"]                                   # error
    )
    results = BatchedCorpusDecoder(workers=2).decode_all(items)
    assert [r.ok for r in results] == [True] * 5 + [False]
    for data, r in zip(items[:5], results[:5]):
        want = decode_bytes(data, path="fast")
        np.testing.assert_array_equal(r.rgb, want)


def test_batched_corpus_decoder_sharded():
    from jpeg_tpu.parallel.mesh import make_mesh
    from jpeg_tpu.parallel.pipeline import BatchedCorpusDecoder

    mesh = make_mesh(n_data=4, n_seg=1)
    items = [synthetic_jpeg(96, 64, seed=i) for i in range(6)]  # 4 + 2 spill
    results = BatchedCorpusDecoder(workers=2, mesh=mesh).decode_all(items)
    assert all(r.ok for r in results)
    for data, r in zip(items, results):
        np.testing.assert_array_equal(r.rgb, decode_bytes(data, path="fast"))


def test_mixed_corpus_stress():
    """Kitchen-sink corpus through the batched decoder: mixed geometries,
    qualities, baseline/progressive/restart/optimized, plus a corrupt file —
    every good image must match its single-image decode."""
    import io

    from PIL import Image

    from jpeg_tpu.io.corpus import synthetic_image
    from jpeg_tpu.models.encoder import encode_rgb, encode_rgb_progressive
    from jpeg_tpu.parallel.pipeline import BatchedCorpusDecoder

    items = []
    items.append(encode_rgb(synthetic_image(96, 64, seed=1), quality=85))
    items.append(encode_rgb(synthetic_image(96, 64, seed=2), quality=40,
                            subsampling=(1, 1)))
    items.append(encode_rgb(synthetic_image(128, 96, seed=3), quality=90,
                            restart_interval_mcus=2))
    items.append(encode_rgb(synthetic_image(96, 64, seed=4), quality=85,
                            optimize=True))
    items.append(encode_rgb_progressive(synthetic_image(96, 64, seed=5),
                                        quality=85))
    items.append(encode_rgb_progressive(synthetic_image(96, 64, seed=6),
                                        quality=85, restart_interval=2))
    items.append(encode_rgb(synthetic_image(77, 53, seed=7)[..., 0],
                            quality=88))  # grayscale, odd dims
    buf = io.BytesIO()
    Image.fromarray(synthetic_image(96, 64, seed=8)).save(
        buf, "JPEG", quality=85, progressive=True)
    items.append(buf.getvalue())  # PIL progressive
    buf = io.BytesIO()
    Image.fromarray(synthetic_image(96, 64, seed=9)).convert("CMYK").save(
        buf, "JPEG", quality=85)
    items.append(buf.getvalue())  # Adobe CMYK -> inline compat decode
    items.append(b"\xff\xd8 definitely broken")

    results = BatchedCorpusDecoder(workers=3).decode_all(items)
    assert [r.ok for r in results] == [True] * 9 + [False]
    for data, r in zip(items[:9], results[:9]):
        want = decode_bytes(data, path="fast")
        np.testing.assert_array_equal(r.rgb, want)


def test_batched_corpus_mixed_lossless():
    """A lossless (SOF3) file in a batched corpus decodes via the inline
    compat route instead of failing in the 8-bit DCT batch path."""
    import numpy as np

    from jpeg_tpu.entropy.lossless import encode_lossless
    from jpeg_tpu.io.corpus import synthetic_jpeg
    from jpeg_tpu.parallel.pipeline import BatchedCorpusDecoder

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (32, 40, 3), dtype=np.uint8)
    res = BatchedCorpusDecoder().decode_all(
        [synthetic_jpeg(64, 48, seed=1), encode_lossless(img, predictor=4)])
    assert all(r.ok for r in res)
    np.testing.assert_array_equal(res[1].rgb, img)


def test_batched_corpus_mixed_routes():
    """Restart, progressive and corrupt items in one batched corpus: each
    image equals its single-image decode, the corrupt one is isolated."""
    from jpeg_tpu.io.corpus import synthetic_image
    from jpeg_tpu.models.encoder import encode_rgb, encode_rgb_progressive
    from jpeg_tpu.parallel.pipeline import BatchedCorpusDecoder

    items = [
        encode_rgb(synthetic_image(96, 64, seed=i), quality=85,
                   subsampling=(2, 2), restart_interval_mcus=3)
        for i in range(5)
    ]
    items.append(encode_rgb_progressive(synthetic_image(96, 64, seed=11),
                                        quality=85))
    items.append(b"\xff\xd8 broken")

    results = BatchedCorpusDecoder(workers=2).decode_all(items)
    assert [r.ok for r in results] == [True] * 6 + [False]
    for data, r in zip(items[:6], results[:6]):
        np.testing.assert_array_equal(r.rgb, decode_bytes(data, path="fast"))


def test_batched_corpus_sharded_with_spill():
    """Under a 4-device data mesh, 8 images shard and the ninth spills to
    an unsharded batch; all equal their single-image decodes."""
    from jpeg_tpu.io.corpus import synthetic_image
    from jpeg_tpu.models.encoder import encode_rgb
    from jpeg_tpu.parallel.mesh import make_mesh
    from jpeg_tpu.parallel.pipeline import BatchedCorpusDecoder

    mesh = make_mesh(n_data=4, n_seg=1)
    items = [encode_rgb(synthetic_image(96, 64, seed=i), quality=85,
                        subsampling=(2, 2), restart_interval_mcus=3)
             for i in range(9)]
    results = BatchedCorpusDecoder(workers=2, mesh=mesh).decode_all(items)
    assert all(r.ok for r in results)
    for data, r in zip(items, results):
        np.testing.assert_array_equal(r.rgb, decode_bytes(data, path="fast"))


def test_idct_mode_approx_plumbed():
    """idct_mode="approx" threads through CorpusDecoder/BatchedCorpusDecoder
    to the pixel stage. On CPU DEFAULT == HIGHEST matmul precision, so the
    output is bit-identical to exact here; the GPU's measured error lives
    in docs/APPROX_QUALITY.md."""
    from jpeg_tpu.io.corpus import synthetic_image
    from jpeg_tpu.models.encoder import encode_rgb
    from jpeg_tpu.parallel.pipeline import BatchedCorpusDecoder, CorpusDecoder

    items = [encode_rgb(synthetic_image(96, 64, seed=i), quality=85,
                        subsampling=(2, 2), restart_interval_mcus=3)
             for i in range(4)]
    for dec in (BatchedCorpusDecoder(workers=2, idct_mode="approx"),
                CorpusDecoder(workers=2, path="fast", idct_mode="approx")):
        results = dec.decode_all(items)
        assert all(r.ok for r in results)
        for data, r in zip(items, results):
            np.testing.assert_array_equal(
                r.rgb, decode_bytes(data, path="fast"))


def test_cli_idct_flag():
    from jpeg_tpu.cli import main as cli_main
    import os
    import tempfile

    from jpeg_tpu.io.corpus import synthetic_image
    from jpeg_tpu.models.encoder import encode_rgb

    with tempfile.TemporaryDirectory() as d:
        jp = os.path.join(d, "a.jpg")
        pp = os.path.join(d, "a.ppm")
        with open(jp, "wb") as f:
            f.write(encode_rgb(synthetic_image(96, 64, seed=0), quality=85,
                               subsampling=(2, 2), restart_interval_mcus=3))
        assert cli_main(["decode", jp, pp, "--path", "fast",
                         "--idct", "approx"]) == 0
        assert cli_main(["corpus", d, "--batched", "--idct", "approx"]) == 0


def test_batched_corpus_decodes_arithmetic():
    """SOF9 arithmetic images must route through the QM decoder in the
    batched corpus path (they hit the Huffman tier and errored before —
    found by the r5 CLI surface sweep)."""
    from jpeg_tpu.io.corpus import synthetic_image
    from jpeg_tpu.models.encoder import encode_rgb
    from jpeg_tpu.parallel.pipeline import BatchedCorpusDecoder

    items = [encode_rgb(synthetic_image(96, 64, seed=i), quality=85,
                        subsampling=(2, 2), restart_interval_mcus=3)
             for i in range(4)]
    items.append(encode_rgb(synthetic_image(96, 64, seed=9), quality=85,
                            subsampling=(2, 2), arithmetic=True,
                            restart_interval_mcus=3))
    results = BatchedCorpusDecoder(workers=2).decode_all(items)
    assert all(r.ok for r in results), [r.error for r in results]
    for data, r in zip(items, results):
        np.testing.assert_array_equal(r.rgb, decode_bytes(data, path="fast"))
