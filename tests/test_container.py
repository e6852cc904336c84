"""Container/marker parser tests.

The geometry tests encode seeded images with the sizes and samplings of the
reference corpus files (facts verified in SURVEY.md §2, C10).
"""

import numpy as np
import pytest

from jpeg_tpu.io.container import JPEGError, parse_jpeg


def _seeded(width, height, subsampling=None):
    """Seeded stream from the repo's encoder; ``None`` = grayscale."""
    from jpeg_tpu.io.corpus import synthetic_image
    from jpeg_tpu.models.encoder import encode_rgb

    img = synthetic_image(width, height, seed=width + height)
    if subsampling is None:
        return encode_rgb(img[..., 0], quality=85)
    return encode_rgb(img, quality=85, subsampling=subsampling)


def test_huff_simple0():
    plan = parse_jpeg(_seeded(16, 8, (1, 1)))
    assert (plan.width, plan.height) == (16, 8)
    assert len(plan.components) == 3
    assert all((c.h, c.v) == (1, 1) for c in plan.components)
    assert plan.h_max == plan.v_max == 1
    assert (plan.mcus_x, plan.mcus_y) == (2, 1)
    assert plan.blocks_per_mcu == 3
    assert plan.total_blocks == 6
    assert len(plan.segments) == 1
    assert plan.restart_interval == 0


def test_lena_bw():
    plan = parse_jpeg(_seeded(512, 512))
    assert (plan.width, plan.height) == (512, 512)
    assert len(plan.components) == 1
    assert (plan.mcus_x, plan.mcus_y) == (64, 64)
    assert plan.total_blocks == 64 * 64


def test_lena_422():
    plan = parse_jpeg(_seeded(512, 512, (2, 1)))
    assert (plan.width, plan.height) == (512, 512)
    assert [(c.h, c.v) for c in plan.components] == [(2, 1), (1, 1), (1, 1)]
    assert (plan.h_max, plan.v_max) == (2, 1)
    assert (plan.mcus_x, plan.mcus_y) == (32, 64)
    assert plan.blocks_per_mcu == 4


def test_2x2_chroma():
    plan = parse_jpeg(_seeded(750, 595, (2, 2)))
    assert (plan.width, plan.height) == (750, 595)
    assert [(c.h, c.v) for c in plan.components] == [(2, 2), (1, 1), (1, 1)]
    # Spec-correct MCU geometry (the reference under-counts here; SURVEY §2).
    assert (plan.mcus_x, plan.mcus_y) == (47, 38)
    assert plan.blocks_per_mcu == 6


def test_tables_registered(stream_corpus):
    plan = parse_jpeg(stream_corpus["422"])
    for c in plan.components:
        assert plan.dc_tables[c.dc_id].values.size > 0
        assert plan.ac_tables[c.ac_id].values.size > 0
        assert plan.quant_tables[c.quant_id].max() > 0


def test_not_a_jpeg():
    with pytest.raises(JPEGError):
        parse_jpeg(b"\x89PNG\r\n\x1a\n" + b"\x00" * 100)


def test_truncated_stream(stream_corpus):
    with pytest.raises(JPEGError):
        parse_jpeg(stream_corpus["422"][:20])


def test_progressive_parses(stream_corpus):
    # Flip SOF0 (0xC0) to progressive (0xC2): now parsed as a progressive
    # stream (one pseudo-scan); decoding validates scan structure separately.
    data = bytearray(stream_corpus["gray-nort"])
    idx = bytes(data).find(b"\xff\xc0")
    assert idx > 0
    data[idx + 1] = 0xC2
    plan = parse_jpeg(bytes(data))
    assert plan.progressive and len(plan.prog_scans) == 1


def test_extended_sof_rejected_cleanly(stream_corpus):
    data = bytearray(stream_corpus["gray-nort"])
    idx = bytes(data).find(b"\xff\xc0")
    data[idx + 1] = 0xC5  # differential/hierarchical: unsupported
    with pytest.raises(JPEGError, match="SOF"):
        parse_jpeg(bytes(data))
    # SOF3 is supported since r4, but a baseline stream masquerading as
    # lossless still fails cleanly: its SOS Ss=0 is not a predictor.
    data[idx + 1] = 0xC3
    with pytest.raises(JPEGError, match="predictor"):
        parse_jpeg(bytes(data))


def test_unstuffing_synthetic():
    from jpeg_tpu.io.container import _unstuff_and_segment

    # Entropy data: FF(stuffed) 12, FF(stuffed) 00(real data), then RST0
    # splitting segments, then AB CD, terminated by EOI.
    raw = np.array(
        [0xFF, 0x00, 0x12, 0xFF, 0x00, 0x00, 0xFF, 0xD0, 0xAB, 0xCD, 0xFF, 0xD9],
        dtype=np.uint8,
    )
    data, bounds, end = _unstuff_and_segment(raw, 0)
    assert data.tolist() == [0xFF, 0x12, 0xFF, 0x00, 0xAB, 0xCD]
    assert bounds == [(0, 4), (4, 6)]
    assert raw[end:].tolist() == [0xFF, 0xD9]


def test_unstuffing_counts(stream_corpus):
    plan = parse_jpeg(stream_corpus["422"])
    # Every 0xFF in the unstuffed entropy stream was a stuffed data byte;
    # total length shrinks by exactly the number of FF00 pairs in the raw scan.
    assert plan.scan_data.size > 0


def test_nonstandard_table_slot_ids():
    """Relabel Huffman table id 1 -> 3 in DHT and SOS; decode must be
    unchanged (exercises the full 4-slot table plumbing, reference
    src/jpeg/mod.rs:75-79)."""
    from jpeg_tpu.io.corpus import synthetic_jpeg
    from jpeg_tpu.models.decoder import decode_bytes

    data = bytearray(synthetic_jpeg(64, 48, seed=3))
    want = decode_bytes(bytes(data))
    i = 2
    while i < len(data) - 1:
        assert data[i] == 0xFF
        marker = data[i + 1]
        seg_len = int.from_bytes(data[i + 2 : i + 4], "big")
        if marker == 0xC4 and (data[i + 4] & 0x0F) == 1:
            data[i + 4] = (data[i + 4] & 0xF0) | 0x03
        if marker == 0xDA:
            # scan component table selectors at i+6, i+8, i+10
            for off in (6, 8, 10):
                b = data[i + off]
                dc, ac = (b >> 4) & 0xF, b & 0xF
                dc = 3 if dc == 1 else dc
                ac = 3 if ac == 1 else ac
                data[i + off] = (dc << 4) | ac
            break
        i += 2 + seg_len
    got = decode_bytes(bytes(data))
    np.testing.assert_array_equal(got, want)


def test_exif_app1_parsing():
    """EXIF APP1 (reference has no APP1 support at all): orientation + make
    extracted; decode unaffected."""
    import struct

    from jpeg_tpu.io.corpus import synthetic_jpeg
    from jpeg_tpu.models.decoder import decode_bytes

    base = synthetic_jpeg(48, 32, seed=1)
    # Build a little-endian EXIF blob: IFD0 with orientation=6, make="cam".
    make_bytes = b"cams\x00"  # 5 bytes -> stored at offset (not inline)
    ifd_off = 8
    n_entries = 2
    values_off = ifd_off + 2 + n_entries * 12 + 4
    tiff = b"II" + struct.pack("<HI", 42, ifd_off)
    tiff += struct.pack("<H", n_entries)
    tiff += struct.pack("<HHII", 0x0112, 3, 1, 6)  # orientation SHORT 6
    tiff += struct.pack("<HHII", 0x010F, 2, len(make_bytes), values_off)
    tiff += struct.pack("<I", 0)  # next IFD
    tiff += make_bytes
    payload = b"Exif\x00\x00" + tiff
    app1 = b"\xff\xe1" + (len(payload) + 2).to_bytes(2, "big") + payload
    data = base[:2] + app1 + base[2:]

    plan = parse_jpeg(data)
    assert plan.exif == {"orientation": 6, "make": "cams"}
    np.testing.assert_array_equal(decode_bytes(data), decode_bytes(base))


def test_garbled_app1_ignored():
    from jpeg_tpu.io.corpus import synthetic_jpeg

    base = synthetic_jpeg(32, 32, seed=2)
    app1 = b"\xff\xe1\x00\x0aExif\x00\x00XX"
    plan = parse_jpeg(base[:2] + app1 + base[2:])
    assert plan.exif is None


def test_native_unstuff_matches_numpy():
    """C++ single-pass unstuff+segment scan == the NumPy implementation."""
    import io

    from PIL import Image

    from jpeg_tpu.io.container import _unstuff_and_segment
    from jpeg_tpu.io.corpus import synthetic_image
    from jpeg_tpu.runtime import native_available, native_unstuff_scan

    if not native_available():
        pytest.skip("native runtime not built")
    buf = io.BytesIO()
    Image.fromarray(synthetic_image(512, 256, seed=90)).save(
        buf, "JPEG", quality=95, restart_marker_rows=1)
    raw = np.frombuffer(buf.getvalue(), dtype=np.uint8)
    sos = bytes(buf.getvalue()).find(b"\xff\xda")
    start = sos + 2 + int.from_bytes(buf.getvalue()[sos + 2 : sos + 4], "big")
    # Compare on a slice under the dispatch threshold so
    # _unstuff_and_segment takes the NumPy path.
    small = raw[: start + 60000]
    want = _unstuff_and_segment(small, start)
    got = native_unstuff_scan(small, start)
    assert np.array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert got[2] == want[2]


def test_exif_orientation_applied(tmp_path):
    """decode_file(exif_orientation=True) rotates per the EXIF tag."""
    import struct

    from jpeg_tpu.io.corpus import synthetic_jpeg
    from jpeg_tpu.models.decoder import (
        apply_exif_orientation,
        decode_bytes,
        decode_file,
    )

    base = synthetic_jpeg(48, 32, seed=10)  # 48 wide, 32 tall
    tiff = b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
    tiff += struct.pack("<HHII", 0x0112, 3, 1, 6)  # orientation = 6 (rot 90)
    tiff += struct.pack("<I", 0)
    payload = b"Exif\x00\x00" + tiff
    app1 = b"\xff\xe1" + (len(payload) + 2).to_bytes(2, "big") + payload
    p = tmp_path / "o.jpg"
    p.write_bytes(base[:2] + app1 + base[2:])
    plain = decode_bytes(base)
    rotated = decode_file(str(p), exif_orientation=True)
    assert rotated.shape == (48, 32, 3)  # rotated 90
    np.testing.assert_array_equal(rotated, apply_exif_orientation(plain, 6))
    # identity tags
    np.testing.assert_array_equal(apply_exif_orientation(plain, 1), plain)
    assert apply_exif_orientation(plain, 3).shape == plain.shape


def _widen_dqt_to_16bit(data: bytes) -> bytes:
    """Rewrite every 8-bit DQT segment as an equivalent 16-bit one
    (Pq=1, hi byte 0) — exercises the precision-1 path of B.2.4.1
    (parity src/jpeg/mod.rs:236-259)."""
    d = bytes(data)
    res = bytearray()
    pos = 0
    while True:
        i = d.find(b"\xff\xdb", pos)
        if i < 0:
            res += d[pos:]
            break
        seg_len = (d[i + 2] << 8) | d[i + 3]
        body = d[i + 4 : i + 2 + seg_len]
        new_body = bytearray()
        j = 0
        while j < len(body):
            assert body[j] >> 4 == 0, "input DQT already 16-bit"
            new_body.append(0x10 | (body[j] & 0x0F))
            for b in body[j + 1 : j + 65]:
                new_body += bytes([0, b])
            j += 65
        new_len = 2 + len(new_body)
        res += d[pos:i]
        res += b"\xff\xdb" + bytes([new_len >> 8, new_len & 0xFF]) + new_body
        pos = i + 2 + seg_len
    return bytes(res)


def test_16bit_dqt_parses_and_decodes_identically():
    import jpeg_tpu
    from jpeg_tpu.io.corpus import synthetic_image
    from jpeg_tpu.models.encoder import encode_rgb

    data = encode_rgb(synthetic_image(64, 48, seed=7), quality=80)
    wide = _widen_dqt_to_16bit(data)
    p8, p16 = parse_jpeg(data), parse_jpeg(wide)
    for a, b in zip(p8.quant_tables, p16.quant_tables):
        if a is not None or b is not None:
            np.testing.assert_array_equal(a, b)
    base = jpeg_tpu.decode_bytes(data)
    for kw in ({"engine": "oracle"}, {"engine": "native"}, {"path": "fast"}):
        np.testing.assert_array_equal(
            jpeg_tpu.decode_bytes(wide, **kw),
            jpeg_tpu.decode_bytes(data, **kw))
    np.testing.assert_array_equal(jpeg_tpu.decode_bytes(wide), base)


def test_16bit_dqt_value_above_255_decodes():
    import jpeg_tpu
    from jpeg_tpu.io.corpus import synthetic_image
    from jpeg_tpu.models.encoder import encode_rgb

    data = encode_rgb(synthetic_image(64, 48, seed=8), quality=80)
    wide = bytearray(_widen_dqt_to_16bit(data))
    i = wide.find(b"\xff\xdb")
    # Entry 63 (highest AC frequency) of the first table -> 300.
    wide[i + 5 + 2 * 63] = 300 >> 8
    wide[i + 5 + 2 * 63 + 1] = 300 & 0xFF
    plan = parse_jpeg(bytes(wide))
    assert 300 in [int(v) for t in plan.quant_tables if t is not None
                   for v in t]
    a = jpeg_tpu.decode_bytes(bytes(wide), engine="oracle")
    b = jpeg_tpu.decode_bytes(bytes(wide), engine="native")
    np.testing.assert_array_equal(a, b)


def test_sos_bad_component_count_rejected(stream_corpus):
    data = bytearray(stream_corpus["444-nort"])
    i = data.find(b"\xff\xda")
    data[i + 4] = 255  # Ns byte
    with pytest.raises(JPEGError):
        parse_jpeg(bytes(data))


def test_sos_truncated_header_rejected(stream_corpus):
    data = bytearray(stream_corpus["444-nort"])
    i = data.find(b"\xff\xda")
    # Declared length too short for Ns=3 components (needs 2+1+6+3=12).
    data[i + 2], data[i + 3] = 0, 5
    with pytest.raises(JPEGError):
        parse_jpeg(bytes(data))


def test_truncated_dqt_segment_rejected():
    # SOI + DQT whose declared length covers only 8 of 65 table bytes.
    stream = b"\xff\xd8" + b"\xff\xdb\x00\x0a" + bytes(8) + b"\xff\xd9"
    with pytest.raises(JPEGError):
        parse_jpeg(stream)


def test_truncated_dht_segment_rejected():
    # SOI + DHT whose declared length covers only 10 of the 17 header bytes.
    stream = b"\xff\xd8" + b"\xff\xc4\x00\x0c" + bytes(10) + b"\xff\xd9"
    with pytest.raises(JPEGError):
        parse_jpeg(stream)


def test_dht_values_truncated_by_segment_length_rejected():
    # Header says 4 symbols of length 1..16 but segment ends after the
    # bits array: count runs past the declared length.
    bits = bytes([4] + [0] * 15)
    stream = (b"\xff\xd8" + b"\xff\xc4\x00\x13" + b"\x00" + bits
              + b"\xff\xd9")
    with pytest.raises(JPEGError):
        parse_jpeg(stream)


def test_sof1_extended_sequential_decodes_as_baseline():
    """SOF1 at 8-bit precision is decode-identical to baseline (more table
    slots, already supported). Flip a baseline stream's SOF0 marker to SOF1
    and require byte-identical pixels across every engine."""
    import jpeg_tpu
    from jpeg_tpu.io.corpus import synthetic_image
    from jpeg_tpu.models.encoder import encode_rgb

    data = encode_rgb(synthetic_image(64, 48, seed=9), quality=80)
    i = data.find(b"\xff\xc0")
    sof1 = data[:i + 1] + b"\xc1" + data[i + 2:]
    assert parse_jpeg(sof1).progressive is False
    base = jpeg_tpu.decode_bytes(data)
    for kw in ({}, {"engine": "oracle"}, {"path": "fast"}):
        np.testing.assert_array_equal(jpeg_tpu.decode_bytes(sof1, **kw), base)


def test_non_8bit_precision_rejected():
    from jpeg_tpu.io.corpus import synthetic_image
    from jpeg_tpu.models.encoder import encode_rgb

    data = bytearray(encode_rgb(synthetic_image(64, 48, seed=9)))
    i = data.find(b"\xff\xc0")
    data[i + 4] = 12  # precision byte (after marker + length)
    with pytest.raises(JPEGError, match="precision"):
        parse_jpeg(bytes(data))


def test_dnl_marker_defines_height():
    """B.2.5: a sequential frame may declare height 0 and supply the real
    line count in a DNL marker after the first scan (beyond the reference
    AND libjpeg, which ignores DNL)."""
    import jpeg_tpu
    from jpeg_tpu.io.corpus import synthetic_image
    from jpeg_tpu.models.encoder import encode_rgb

    img = synthetic_image(64, 48, seed=15)
    data = bytearray(encode_rgb(img, quality=85))
    base = jpeg_tpu.decode_bytes(bytes(data))
    i = data.find(b"\xff\xc0")
    h = (data[i + 5] << 8) | data[i + 6]
    data[i + 5] = data[i + 6] = 0  # SOF height := 0
    assert data[-2:] == b"\xff\xd9"
    dnl = bytes([0xFF, 0xDC, 0, 4, h >> 8, h & 0xFF])
    data = bytes(data[:-2]) + dnl + b"\xff\xd9"
    plan = parse_jpeg(data)
    assert plan.height == h
    np.testing.assert_array_equal(jpeg_tpu.decode_bytes(data), base)
    # Missing DNL -> clean error.
    with pytest.raises(JPEGError, match="DNL"):
        parse_jpeg(data[: -len(dnl) - 2] + b"\xff\xd9")
    # DNL with zero lines -> clean error.
    bad = bytearray(data)
    bad[-4] = bad[-3] = 0
    with pytest.raises(JPEGError, match="DNL"):
        parse_jpeg(bytes(bad))


def test_noninterleaved_sequential_scan_rejected():
    """A sequential SOS covering fewer components than the frame (legal
    non-interleaved multi-scan, A.2.2) must raise a clear JPEGError, not
    decode the partial scan as the whole image (it used to escape as an
    OverflowError from the unset table ids)."""
    import numpy as np

    from jpeg_tpu.models.encoder import encode_rgb

    img = np.random.default_rng(0).integers(0, 256, (32, 32, 3),
                                            dtype=np.uint8)
    data = bytearray(encode_rgb(img, quality=85, subsampling=(1, 1)))
    i = data.find(b"\xff\xda")
    ln = (data[i + 2] << 8) | data[i + 3]
    new_sos = bytes([0, 8, 1, data[i + 5], data[i + 6], 0, 63, 0])
    crafted = bytes(data[:i + 2]) + new_sos + bytes(data[i + 2 + ln:])
    with pytest.raises(JPEGError, match="non-interleaved"):
        parse_jpeg(crafted)
