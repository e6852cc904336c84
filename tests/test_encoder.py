"""Encoder tests: spec conformance via PIL and decode round-trips."""

import io

import numpy as np
import pytest
from PIL import Image

from conftest import psnr
from jpeg_tpu.io.container import parse_jpeg
from jpeg_tpu.models.decoder import decode_bytes
from jpeg_tpu.models.encoder import encode_rgb


def _test_image(h=64, w=96, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack(
        [
            128 + 90 * np.sin(xx / 9.0) * np.cos(yy / 7.0),
            128 + 90 * np.cos(xx / 13.0),
            128 + 90 * np.sin(yy / 11.0),
        ],
        axis=-1,
    )
    img += rng.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (2, 2)])
def test_pil_can_decode_our_streams(sub):
    """Our encoder output must be a conformant baseline JPEG: libjpeg decodes
    it and the pixels match the source."""
    img = _test_image()
    data = encode_rgb(img, quality=92, subsampling=sub)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert pil.shape == img.shape
    assert psnr(pil, img) > 30.0


@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (2, 2)])
@pytest.mark.parametrize("ri", [0, 2])
def test_roundtrip_through_our_decoder(sub, ri):
    img = _test_image()
    data = encode_rgb(img, quality=92, subsampling=sub, restart_interval_mcus=ri)
    dec = decode_bytes(data, rounding="round", engine="oracle")
    assert psnr(dec, img) > 30.0


def test_restart_interval_structure():
    img = _test_image(48, 48)
    data = encode_rgb(img, quality=85, subsampling=(2, 2), restart_interval_mcus=1)
    plan = parse_jpeg(data)
    # 48x48 with 4:2:0 -> 3x3 = 9 MCUs -> 9 segments of 1 MCU.
    assert plan.restart_interval == 1
    assert len(plan.segments) == 9
    assert all(s.mcu_count == 1 for s in plan.segments)
    # PIL agrees on the pixels despite restart markers.
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert psnr(pil, img) > 30.0


def test_grayscale_roundtrip():
    img = _test_image()[..., 0]
    data = encode_rgb(img, quality=92)
    dec = decode_bytes(data, rounding="round", engine="oracle")
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert psnr(dec, pil) > 45.0


def test_odd_dimensions():
    """Non-multiple-of-MCU sizes must pad on encode and crop on decode."""
    img = _test_image(37, 53)
    data = encode_rgb(img, quality=92, subsampling=(2, 2))
    dec = decode_bytes(data, rounding="round", engine="oracle")
    assert dec.shape == (37, 53, 3)
    assert psnr(dec, img) > 28.0


@pytest.mark.parametrize("sub", [(1, 1), (2, 2)])
@pytest.mark.parametrize("ri", [0, 3])
def test_native_entropy_encoder_identical(sub, ri):
    """C++ per-segment parallel encoder must be byte-identical to Python."""
    img = _test_image(80, 112, seed=7)
    a = encode_rgb(img, quality=88, subsampling=sub,
                   restart_interval_mcus=ri, engine="python")
    b = encode_rgb(img, quality=88, subsampling=sub,
                   restart_interval_mcus=ri, engine="native")
    assert a == b


def test_native_entropy_encoder_grayscale_identical():
    img = _test_image(64, 64, seed=8)[..., 0]
    a = encode_rgb(img, quality=90, restart_interval_mcus=2, engine="python")
    b = encode_rgb(img, quality=90, restart_interval_mcus=2, engine="native")
    assert a == b


def test_device_encoder_matches_host():
    """The device forward transform produces equivalent streams."""
    from jpeg_tpu.models.encoder import encode_rgb_device

    img = _test_image(96, 144, seed=11)
    for sub in [(1, 1), (2, 2)]:
        a = encode_rgb(img, quality=90, subsampling=sub, restart_interval_mcus=2)
        b = encode_rgb_device(img, quality=90, subsampling=sub,
                              restart_interval_mcus=2)
        da = decode_bytes(a, rounding="round")
        db = decode_bytes(b, rounding="round")
        # Quantization ties may flip a coefficient; decoded images must agree.
        assert psnr(da, db) > 45.0


def test_device_encoder_grayscale():
    from jpeg_tpu.models.encoder import encode_rgb_device

    img = _test_image(64, 80, seed=12)[..., 0]
    data = encode_rgb_device(img, quality=88)
    dec = decode_bytes(data, rounding="round")
    assert psnr(dec[..., 0], img) > 28.0


@pytest.mark.parametrize("sub", [(1, 1), (2, 2)])
def test_optimized_huffman_tables(sub):
    """optimize=True (Annex K.2 per-image tables): smaller stream, identical
    pixels, conformant per libjpeg."""
    import io

    from PIL import Image

    img = _test_image(160, 192, seed=20)
    std = encode_rgb(img, quality=85, subsampling=sub)
    opt = encode_rgb(img, quality=85, subsampling=sub, optimize=True)
    assert len(opt) < len(std)
    np.testing.assert_array_equal(
        decode_bytes(std, rounding="round"), decode_bytes(opt, rounding="round")
    )
    pil = np.asarray(Image.open(io.BytesIO(opt)).convert("RGB"))
    # 4:4:4 differs only by rounding; subsampled adds the replicated-vs-
    # fancy-upsampling gap.
    floor = 50 if sub == (1, 1) else 35
    assert psnr(pil, decode_bytes(opt, rounding="round")) > floor


def test_optimized_huffman_restart_and_engines():
    img = _test_image(96, 96, seed=21)
    a = encode_rgb(img, quality=90, restart_interval_mcus=2, optimize=True,
                   engine="python")
    b = encode_rgb(img, quality=90, restart_interval_mcus=2, optimize=True,
                   engine="native")
    assert a == b
    assert decode_bytes(a, rounding="round").shape == img.shape


def test_optimized_huffman_grayscale():
    img = _test_image(64, 64, seed=22)[..., 0]
    opt = encode_rgb(img, quality=85, optimize=True)
    std = encode_rgb(img, quality=85)
    assert len(opt) < len(std)
    np.testing.assert_array_equal(decode_bytes(opt), decode_bytes(std))


def test_device_encoder_optimize():
    from jpeg_tpu.models.encoder import encode_rgb_device

    img = _test_image(96, 96, seed=23)
    std = encode_rgb_device(img, quality=88, subsampling=(2, 2))
    opt = encode_rgb_device(img, quality=88, subsampling=(2, 2), optimize=True)
    assert len(opt) < len(std)
    np.testing.assert_array_equal(decode_bytes(std), decode_bytes(opt))


def test_comment_roundtrip():
    """COM segment write + parse (reference parses comments,
    src/jpeg/mod.rs:222-227; ours also writes them)."""
    img = _test_image(32, 32)
    data = encode_rgb(img, quality=90, comment="hello jpeg_tpu")
    plan = parse_jpeg(data)
    assert plan.comment == "hello jpeg_tpu"
    decode_bytes(data)  # still decodes
