"""Arithmetic-coded JPEG (SOF9, T.81 Annex D/F) — validated against
libjpeg-turbo's QM codec in BOTH directions.

Goldens (tests/goldens/arith_libjpeg.npz) were produced by the system
libjpeg via tools/jpeg_arith_ref.c: the encoded streams, their
entropy-layer coefficient dumps (jpeg_read_coefficients), and libjpeg's
own decoded pixels. Our encoder's streams are independently decoded by
PIL (whose libjpeg-turbo ships the arithmetic codec).
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

import jpeg_tpu
from jpeg_tpu.entropy.arith import decode_coefficients_arith
from jpeg_tpu.io.container import JPEGError, parse_jpeg
from jpeg_tpu.io.corpus import synthetic_image
from jpeg_tpu.models.encoder import encode_rgb
from jpeg_tpu.ops.zigzag import unzigzag

from conftest import psnr

GOLD = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "goldens", "arith_libjpeg.npz"))


def _coeff_grids(plan, coeffs):
    """[total_blocks, 64] stream -> per-component [by, bx, 64] grids."""
    slots = plan.component_block_slots()
    bpm = plan.blocks_per_mcu
    my, mx = np.divmod(np.arange(plan.n_mcus), plan.mcus_x)
    grids = {}
    for si, (ci, sub) in enumerate(slots):
        c = plan.components[ci]
        vi, hi = divmod(sub, c.h)
        if ci not in grids:
            grids[ci] = np.zeros(
                (plan.mcus_y * c.v, plan.mcus_x * c.h, 64), np.int32)
        grids[ci][my * c.v + vi, mx * c.h + hi] = coeffs[si::bpm]
    return grids


@pytest.mark.parametrize("name", ["color", "rst", "gray"])
def test_decode_coefficients_match_libjpeg(name):
    data = GOLD[f"{name}_jpg"].tobytes()
    plan = parse_jpeg(data)
    assert plan.arith_code
    if name == "rst":
        assert len(plan.segments) > 1
    grids = _coeff_grids(plan, decode_coefficients_arith(plan))
    ci = 0
    while f"{name}_coef{ci}" in GOLD:
        ref = GOLD[f"{name}_coef{ci}"]
        bh, bw = ref.shape[:2]
        mine = np.stack([
            unzigzag(grids[ci][by, bx])
            for by in range(bh) for bx in range(bw)
        ]).reshape(bh, bw, 64)
        np.testing.assert_array_equal(mine, ref.astype(np.int32))
        ci += 1


@pytest.mark.parametrize("name", ["color", "rst", "gray"])
def test_decode_pixels_close_to_libjpeg(name):
    data = GOLD[f"{name}_jpg"].tobytes()
    ours = np.asarray(jpeg_tpu.decode_bytes(data, rounding="round"))
    ref = GOLD[f"{name}_pil"]
    assert ours.shape == ref.shape
    # Entropy-exact; remaining differences are IDCT/upsample rounding.
    assert psnr(ours, ref) > 40.0


def test_encode_roundtrip_and_pil_cross_decode():
    img = synthetic_image(96, 64, seed=2)
    data = encode_rgb(img, quality=85, arithmetic=True)
    plan = parse_jpeg(data)
    assert plan.arith_code
    # Coefficient-exact vs the Huffman encode of the same transform.
    huff = encode_rgb(img, quality=85)
    np.testing.assert_array_equal(jpeg_tpu.decode_bytes(data),
                                  jpeg_tpu.decode_bytes(huff))
    # Independent: libjpeg (PIL) decodes our arithmetic stream.
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert psnr(np.asarray(jpeg_tpu.decode_bytes(data, rounding="round")),
                pil) > 40.0
    # And it is smaller than the Huffman stream (the point of arithmetic).
    assert len(data) < len(huff)


def test_encode_restart_intervals():
    img = synthetic_image(112, 80, seed=3)
    data = encode_rgb(img, quality=80, arithmetic=True,
                      restart_interval_mcus=2)
    plan = parse_jpeg(data)
    assert plan.arith_code and len(plan.segments) > 1
    huff = encode_rgb(img, quality=80, restart_interval_mcus=2)
    np.testing.assert_array_equal(jpeg_tpu.decode_bytes(data),
                                  jpeg_tpu.decode_bytes(huff))
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert psnr(np.asarray(jpeg_tpu.decode_bytes(data, rounding="round")),
                pil) > 40.0


def test_encode_grayscale():
    img = synthetic_image(64, 48, seed=4)[:, :, 0].copy()
    data = encode_rgb(img, quality=85, grayscale=True, arithmetic=True)
    plan = parse_jpeg(data)
    assert plan.arith_code and len(plan.components) == 1
    huff = encode_rgb(img, quality=85, grayscale=True)
    np.testing.assert_array_equal(jpeg_tpu.decode_bytes(data),
                                  jpeg_tpu.decode_bytes(huff))


def test_dac_validation():
    data = bytearray(GOLD["color_jpg"].tobytes())
    i = data.find(b"\xff\xcc")
    assert i > 0
    # DC conditioning with L > U
    bad = bytearray(data)
    bad[i + 5] = 0x0F  # Cs: U=0, L=15
    with pytest.raises(JPEGError, match="conditioning"):
        parse_jpeg(bytes(bad))
    # AC Kx = 0
    bad = bytearray(data)
    assert bad[i + 6] == 0x10  # Tc=1, Tb=0
    bad[i + 7] = 0
    with pytest.raises(JPEGError, match="Kx"):
        parse_jpeg(bytes(bad))


def test_truncation_and_bitflips_do_not_crash():
    rng = np.random.default_rng(0)
    data = GOLD["rst_jpg"].tobytes()
    for pct in (30, 60, 90):
        trunc = data[: len(data) * pct // 100]
        try:
            rgb = jpeg_tpu.decode_bytes(trunc)
            assert rgb.shape == (64, 96, 3)
        except ValueError:
            pass
    for seed in range(8):
        d = bytearray(data)
        for _ in range(3):
            d[rng.integers(2, len(d))] ^= 1 << rng.integers(0, 8)
        try:
            jpeg_tpu.decode_bytes(bytes(d))
        except ValueError:
            pass


def test_lossless_sof_rejected_cleanly():
    data = bytearray(GOLD["color_jpg"].tobytes())
    i = data.find(b"\xff\xc9")
    data[i + 1] = 0xCB  # SOF11: lossless (unsupported)
    with pytest.raises(JPEGError, match="SOF"):
        parse_jpeg(bytes(data))


def test_progressive_arithmetic_decode_matches_libjpeg():
    """SOF10 stream produced by libjpeg: coefficient-exact decode."""
    from jpeg_tpu.entropy.arith import decode_progressive_coefficients_arith

    data = GOLD["prog_jpg"].tobytes()
    plan = parse_jpeg(data)
    assert plan.progressive and plan.arith_code
    assert len(plan.prog_scans) == 10
    grids = _coeff_grids(plan, decode_progressive_coefficients_arith(plan))
    ci = 0
    while f"prog_coef{ci}" in GOLD:
        ref = GOLD[f"prog_coef{ci}"]
        bh, bw = ref.shape[:2]
        mine = np.stack([
            unzigzag(grids[ci][by, bx])
            for by in range(bh) for bx in range(bw)
        ]).reshape(bh, bw, 64)
        np.testing.assert_array_equal(mine, ref.astype(np.int32))
        ci += 1
    ours = np.asarray(jpeg_tpu.decode_bytes(data, rounding="round"))
    assert psnr(ours, GOLD["prog_pil"]) > 40.0


def test_progressive_arithmetic_encode_roundtrip():
    from jpeg_tpu.models.encoder import encode_rgb_progressive

    img = synthetic_image(96, 64, seed=5)
    base = jpeg_tpu.decode_bytes(encode_rgb(img, quality=85))
    for kw in ({}, {"restart_interval": 3}):
        data = encode_rgb_progressive(img, quality=85, arithmetic=True, **kw)
        plan = parse_jpeg(data)
        assert plan.progressive and plan.arith_code
        np.testing.assert_array_equal(jpeg_tpu.decode_bytes(data), base)
        # Independent cross-check: libjpeg (PIL) decodes our SOF10 stream.
        pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert psnr(np.asarray(jpeg_tpu.decode_bytes(data, rounding="round")),
                    pil) > 40.0


def test_progressive_arithmetic_grayscale_roundtrip():
    from jpeg_tpu.models.encoder import encode_rgb_progressive

    img = synthetic_image(64, 48, seed=6)[:, :, 0].copy()
    base = jpeg_tpu.decode_bytes(encode_rgb(img, quality=85, grayscale=True))
    data = encode_rgb_progressive(img, quality=85, grayscale=True,
                                  arithmetic=True)
    plan = parse_jpeg(data)
    assert plan.progressive and plan.arith_code
    np.testing.assert_array_equal(jpeg_tpu.decode_bytes(data), base)


def test_native_arith_decoder_matches_python():
    """The C++ QM decoder (thread-parallel over restart segments) is
    bit-identical to the Python module on every golden."""
    from jpeg_tpu.runtime import (
        native_decode_arith_coefficients,
        native_decode_arith_planes,
    )

    for name in ("color", "rst", "gray"):
        plan = parse_jpeg(GOLD[f"{name}_jpg"].tobytes())
        np.testing.assert_array_equal(
            native_decode_arith_coefficients(plan),
            decode_coefficients_arith(plan))
        native_decode_arith_planes(plan, reuse_buffer=False)


def test_fast_path_arith_sequential():
    """Sequential arithmetic streams ride the plane path via the C++
    plane decoder; progressive arithmetic falls back to compat."""
    data = GOLD["rst_jpg"].tobytes()
    a = jpeg_tpu.decode_bytes(data)
    b = jpeg_tpu.decode_bytes(data, path="fast")
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    pdata = GOLD["prog_jpg"].tobytes()
    np.testing.assert_array_equal(
        jpeg_tpu.decode_bytes(pdata, path="fast"),
        jpeg_tpu.decode_bytes(pdata))


def test_native_arith_corrupt_stream_raises():
    from jpeg_tpu.runtime import NativeDecodeError, native_decode_arith_planes

    data = bytearray(GOLD["color_jpg"].tobytes())
    plan = parse_jpeg(bytes(data))
    # Poison the conditioning so magnitudes overflow deterministically? A
    # simpler deterministic corruption: an all-0xFF entropy body decodes
    # garbage magnitudes that trip the 0x8000 guard or decodes cleanly —
    # either way it must not crash; exercised via bitflips:
    rng = np.random.default_rng(1)
    for seed in range(6):
        d = bytearray(data)
        for _ in range(4):
            d[rng.integers(len(d) - 40, len(d) - 2)] ^= 0xFF
        try:
            jpeg_tpu.decode_bytes(bytes(d), path="fast")
        except ValueError:
            pass


def test_native_arith_encoder_byte_identical_to_python():
    img = synthetic_image(112, 80, seed=7)
    for ri in (0, 2):
        nat = encode_rgb(img, quality=85, arithmetic=True,
                         restart_interval_mcus=ri, engine="native")
        py = encode_rgb(img, quality=85, arithmetic=True,
                        restart_interval_mcus=ri, engine="python")
        assert nat == py
        pil = np.asarray(Image.open(io.BytesIO(nat)).convert("RGB"))
        assert pil.shape == (80, 112, 3)


@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (2, 2)])
def test_arith_subsampling_matrix(sub):
    img = synthetic_image(96, 64, seed=13)
    data = encode_rgb(img, quality=85, subsampling=sub, arithmetic=True)
    huff = encode_rgb(img, quality=85, subsampling=sub)
    np.testing.assert_array_equal(jpeg_tpu.decode_bytes(data),
                                  jpeg_tpu.decode_bytes(huff))
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert psnr(np.asarray(jpeg_tpu.decode_bytes(data, rounding="round")),
                pil) > 40.0


def test_cli_encode_arithmetic(tmp_path):
    from PIL import Image as _I

    from jpeg_tpu.cli import main as cli_main

    src = tmp_path / "in.png"
    _I.fromarray(synthetic_image(64, 48, seed=14)).save(src)
    out = tmp_path / "out.jpg"
    assert cli_main(["encode", str(src), str(out), "--arithmetic"]) == 0
    plan = parse_jpeg(out.read_bytes())
    assert plan.arith_code and not plan.progressive
    assert cli_main(["encode", str(src), str(out), "--arithmetic",
                     "--progressive"]) == 0
    plan = parse_jpeg(out.read_bytes())
    assert plan.arith_code and plan.progressive


def test_native_progressive_arith_matches_python():
    from jpeg_tpu.entropy.arith import decode_progressive_coefficients_arith
    from jpeg_tpu.models.encoder import encode_rgb_progressive
    from jpeg_tpu.runtime import native_decode_progressive

    plan = parse_jpeg(GOLD["prog_jpg"].tobytes())
    np.testing.assert_array_equal(native_decode_progressive(plan),
                                  decode_progressive_coefficients_arith(plan))
    # Our own SOF10 with restart intervals.
    img = synthetic_image(96, 64, seed=5)
    d = encode_rgb_progressive(img, quality=85, arithmetic=True,
                               restart_interval=3)
    p2 = parse_jpeg(d)
    np.testing.assert_array_equal(native_decode_progressive(p2),
                                  decode_progressive_coefficients_arith(p2))
    # SOF10 rides the plane path via the native plane assembly.
    a = jpeg_tpu.decode_bytes(d)
    b = jpeg_tpu.decode_bytes(d, path="fast")
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


@pytest.mark.parametrize("ycck", [False, True])
def test_cmyk_arithmetic_encode(ycck):
    """4-component Adobe CMYK/YCCK with arithmetic entropy: same pixels as
    the Huffman encode of the same transform; PIL cross-decodes."""
    from jpeg_tpu.models.encoder import encode_cmyk

    img = synthetic_image(96, 64, seed=16)
    cmyk = np.asarray(Image.fromarray(img).convert("CMYK"))
    a = encode_cmyk(cmyk, quality=85, ycck=ycck, arithmetic=True)
    h = encode_cmyk(cmyk, quality=85, ycck=ycck)
    plan = parse_jpeg(a)
    assert plan.arith_code and len(plan.components) == 4
    np.testing.assert_array_equal(jpeg_tpu.decode_bytes(a),
                                  jpeg_tpu.decode_bytes(h))
    pil = np.asarray(Image.open(io.BytesIO(a)).convert("RGB"))
    assert psnr(np.asarray(jpeg_tpu.decode_bytes(a, rounding="round")),
                pil) > 38.0
