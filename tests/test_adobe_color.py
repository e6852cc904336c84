"""Adobe APP14 color models: CMYK / YCCK 4-component and RGB-direct
3-component streams (beyond the reference, which supports 1 or 3 YCbCr
components only — src/jpeg/decoder.rs:317-331)."""

import io

import numpy as np
import pytest
from PIL import Image

import jpeg_tpu
from jpeg_tpu.io.container import parse_jpeg
from jpeg_tpu.io.corpus import synthetic_image

from conftest import psnr


def _cmyk_bytes(quality=95):
    img = synthetic_image(96, 64, seed=3)
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, "JPEG", quality=quality)
    return img, buf.getvalue()


def test_cmyk_detection_and_decode_matches_pil():
    img, data = _cmyk_bytes()
    plan = parse_jpeg(data)
    assert plan.color_model == "cmyk" and plan.adobe_transform == 0
    assert [c.component_id for c in plan.components] == [67, 77, 89, 75]
    ours = jpeg_tpu.decode_bytes(data, rounding="round")
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert ours.shape == pil.shape
    assert psnr(ours, pil) > 55.0  # rounding-only differences
    assert psnr(ours, img) > 35.0


def test_cmyk_fast_path_falls_back_to_compat():
    _, data = _cmyk_bytes()
    np.testing.assert_array_equal(
        jpeg_tpu.decode_bytes(data, path="fast"), jpeg_tpu.decode_bytes(data))


def test_cmyk_engines_agree():
    _, data = _cmyk_bytes()
    np.testing.assert_array_equal(
        jpeg_tpu.decode_bytes(data, engine="oracle"),
        jpeg_tpu.decode_bytes(data, engine="native"))


def test_rgb_direct_matches_pil():
    img = synthetic_image(96, 64, seed=3)
    buf = io.BytesIO()
    try:
        Image.fromarray(img).save(buf, "JPEG", quality=95, keep_rgb=True)
    except TypeError:
        pytest.skip("Pillow without keep_rgb")
    data = buf.getvalue()
    plan = parse_jpeg(data)
    assert plan.color_model == "rgb"
    assert [c.component_id for c in plan.components] == [82, 71, 66]
    ours = jpeg_tpu.decode_bytes(data, rounding="round")
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert psnr(ours, pil) > 55.0


def test_ycck_formula_consistent_with_cmyk():
    """Choosing YCbCr = forward(255 - stored_CMY) must make the YCCK path
    reproduce the plain-CMYK result (validates the libjpeg ycck_cmyk
    inversion wiring)."""
    from jpeg_tpu.ops.color import C_BLUE, C_GREEN, C_RED, cmyk_to_rgb

    rng = np.random.default_rng(0)
    stored = rng.uniform(5, 250, (3, 16, 16)).astype(np.float32)
    k = rng.uniform(5, 250, (16, 16)).astype(np.float32)
    # forward YCbCr of the non-inverted ink (255 - stored), centered
    r, g, b = 255.0 - stored
    y = C_RED * r + C_GREEN * g + C_BLUE * b - 128.0
    cb = (b - (y + 128.0)) / (2.0 - 2.0 * C_BLUE)
    cr = (r - (y + 128.0)) / (2.0 - 2.0 * C_RED)
    via_ycck = np.asarray(cmyk_to_rgb(y, cb, cr, k - 128.0,
                                      rounding="round", ycck=True))
    direct = np.asarray(cmyk_to_rgb(stored[0] - 128.0, stored[1] - 128.0,
                                    stored[2] - 128.0, k - 128.0,
                                    rounding="round", ycck=False))
    assert np.abs(via_ycck.astype(int) - direct.astype(int)).max() <= 1


def test_ycck_transform_flag_detected():
    _, data = _cmyk_bytes()
    d = bytearray(data)
    i = bytes(d).find(b"Adobe")
    d[i + 11] = 2
    plan = parse_jpeg(bytes(d))
    assert plan.color_model == "ycck"
    out = jpeg_tpu.decode_bytes(bytes(d))  # plumbing: decodes, 3-channel
    assert out.shape[-1] == 3


def test_ycbcr_color_space_output_gives_raw_planes_for_cmyk():
    _, data = _cmyk_bytes()
    from jpeg_tpu.models.decoder import decode_plan

    raw = np.asarray(decode_plan(parse_jpeg(data), color_space="ycbcr"))
    assert raw.shape[-1] == 4  # stored CMYK planes, level-shifted


def test_encode_cmyk_roundtrip_pil_and_self():
    """encode_cmyk emits an Adobe transform-0 stream Pillow opens as CMYK;
    our decode matches Pillow's RGB decode within rounding."""
    from jpeg_tpu.models.encoder import encode_cmyk

    img = synthetic_image(96, 64, seed=3)
    cmyk = np.asarray(Image.fromarray(img).convert("CMYK"))
    data = encode_cmyk(cmyk, quality=92)
    pil_img = Image.open(io.BytesIO(data))
    assert pil_img.mode == "CMYK" and pil_img.size == (96, 64)
    assert psnr(np.asarray(pil_img), cmyk) > 35.0  # lossy roundtrip
    ours = jpeg_tpu.decode_bytes(data, rounding="round")
    pil_rgb = np.asarray(pil_img.convert("RGB"))
    assert psnr(ours, pil_rgb) > 55.0
    # engines byte-identical; restart intervals parse back
    assert data == encode_cmyk(cmyk, quality=92, engine="python")
    rst = encode_cmyk(cmyk, quality=92, restart_interval_mcus=3)
    plan = parse_jpeg(rst)
    assert plan.color_model == "cmyk" and len(plan.segments) > 1
    np.testing.assert_array_equal(
        jpeg_tpu.decode_bytes(rst, engine="oracle"),
        jpeg_tpu.decode_bytes(rst, engine="native"))


def test_encode_cmyk_rejects_bad_shapes():
    from jpeg_tpu.models.encoder import encode_cmyk

    for bad in (np.zeros((4, 4, 3), np.uint8), np.zeros((0, 4, 4), np.uint8),
                np.zeros((8, 8), np.uint8)):
        with pytest.raises(ValueError):
            encode_cmyk(bad)


def test_progressive_cmyk_matches_pil():
    """4-component progressive (SOF2) CMYK — the generic component handling
    covers it end to end."""
    img = synthetic_image(96, 64, seed=3)
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(
        buf, "JPEG", quality=92, progressive=True)
    data = buf.getvalue()
    plan = parse_jpeg(data)
    assert plan.color_model == "cmyk" and plan.progressive
    ours = jpeg_tpu.decode_bytes(data, rounding="round")
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert psnr(ours, pil) > 55.0


def test_encode_ycck_roundtrip_pil():
    """encode_cmyk(ycck=True) emits APP14 transform 2; Pillow/libjpeg decode
    it to the same image as the plain-CMYK encode, and our decode matches
    Pillow's — empirical validation of both YCCK directions."""
    from jpeg_tpu.models.encoder import encode_cmyk

    img = synthetic_image(96, 64, seed=3)
    cmyk = np.asarray(Image.fromarray(img).convert("CMYK"))
    d_cmyk = encode_cmyk(cmyk, quality=92)
    d_ycck = encode_cmyk(cmyk, quality=92, ycck=True)
    assert parse_jpeg(d_ycck).color_model == "ycck"
    assert len(d_ycck) < len(d_cmyk)  # decorrelated chroma compresses better
    pil_c = np.asarray(Image.open(io.BytesIO(d_cmyk)).convert("RGB"))
    pil_y = np.asarray(Image.open(io.BytesIO(d_ycck)).convert("RGB"))
    assert psnr(pil_y, pil_c) > 30.0   # same image through both transforms
    ours = jpeg_tpu.decode_bytes(d_ycck, rounding="round")
    assert psnr(ours, pil_y) > 45.0    # our YCCK decode == libjpeg's
    np.testing.assert_array_equal(     # engines bit-identical on YCCK
        jpeg_tpu.decode_bytes(d_ycck, engine="oracle"),
        jpeg_tpu.decode_bytes(d_ycck, engine="native"))


def test_decode_plan_fast_guards_cmyk():
    # decode_plan_fast itself (not just decode_bytes) must detect a
    # 4-component CMYK plan and fall back to the compat pipeline rather
    # than crash in the 3-channel plane path.
    from jpeg_tpu.models.decoder import decode_plan, decode_plan_fast

    _, data = _cmyk_bytes()
    plan = parse_jpeg(data)
    np.testing.assert_array_equal(
        np.asarray(decode_plan_fast(plan)), np.asarray(decode_plan(plan)))


def test_decode_plan_fast_guards_rgb_direct():
    # An Adobe transform-0 RGB stream through the fast path must not be
    # run through the kernel's baked-in YCbCr matrix.
    import io as _io

    from jpeg_tpu.models.decoder import decode_plan, decode_plan_fast

    img = synthetic_image(96, 64, seed=5)
    buf = _io.BytesIO()
    try:
        Image.fromarray(img).save(buf, "JPEG", quality=95, keep_rgb=True)
    except TypeError:
        pytest.skip("Pillow without keep_rgb")
    plan = parse_jpeg(buf.getvalue())
    assert plan.color_model == "rgb"
    np.testing.assert_array_equal(
        np.asarray(decode_plan_fast(plan)), np.asarray(decode_plan(plan)))
