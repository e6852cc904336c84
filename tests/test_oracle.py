"""Entropy oracle unit tests: bit reader + block state machine.

Contract under test: SURVEY.md §3.3 (reference HuffmanDecoder::next_block,
src/jpeg/huffman.rs:146-195).
"""

import numpy as np
import pytest

from jpeg_tpu.entropy.oracle import BitReader, decode_symbol, next_block
from jpeg_tpu.entropy.tables import HuffmanTable


def _bits_to_bytes(bitstring: str) -> np.ndarray:
    bitstring = bitstring.replace(" ", "")
    bitstring += "1" * (-len(bitstring) % 8)
    return np.array(
        [int(bitstring[i : i + 8], 2) for i in range(0, len(bitstring), 8)],
        dtype=np.uint8,
    )


def test_bitreader_msb_first():
    r = BitReader(np.array([0b10110100, 0xFF, 0x00, 0x01, 0x02], dtype=np.uint8))
    assert r.read_bits(1) == 1
    assert r.read_bits(2) == 0b01
    assert r.read_bits(5) == 0b10100
    assert r.read_bits(8) == 0xFF


def test_bitreader_tail_padding_is_0xaa():
    # Reference pads with 0xAA past end (src/jpeg/huffman.rs:240-250).
    r = BitReader(np.array([0x12, 0x34, 0x56, 0x78], dtype=np.uint8))
    assert r.read_bits(16) == 0x1234
    assert r.read_bits(16) == 0x5678
    assert r.read_bits(8) == 0xAA


def test_bitreader_short_stream():
    r = BitReader(np.array([0xAB], dtype=np.uint8))
    assert r.read_bits(8) == 0xAB
    assert r.read_bits(8) == 0xAA


def _simple_tables():
    # Canonical codes for lengths [2, 2, 3, 3] are 00, 01, 100, 101 (Fig C.2).
    # DC: "00" -> size 0, "01" -> size 1, "100" -> size 2, "101" -> size 3.
    dc = HuffmanTable.from_bits_values(
        [0, 2, 2] + [0] * 13, [0, 1, 2, 3]
    )
    # AC: "00" -> EOB, "01" -> (run=0,size=1), "100" -> ZRL, "101" -> (1,2).
    ac = HuffmanTable.from_bits_values(
        [0, 2, 2] + [0] * 13, [0x00, 0x01, 0xF0, 0x12]
    )
    return dc, ac


def test_next_block_dc_only_eob():
    dc, ac = _simple_tables()
    # DC: "01"=size1, bit "1" -> +1 ; AC: EOB "00"
    stream = _bits_to_bytes("01 1 00")
    block = next_block(BitReader(stream), ac, dc)
    assert block[0] == 1
    assert (block[1:] == 0).all()


def test_next_block_zrl_and_run():
    dc, ac = _simple_tables()
    # DC size0 ("00"); AC: ZRL ("100") -> 16 zeros; then (run=1,size=2)
    # ("101") bits "01" -> value_correction(1,2) = -2; then EOB ("00").
    stream = _bits_to_bytes("00 100 101 01 00")
    block = next_block(BitReader(stream), ac, dc)
    assert block[0] == 0
    assert (block[1:17] == 0).all()
    assert block[17] == 0  # run of 1 zero
    assert block[18] == -2
    assert (block[19:] == 0).all()


def test_next_block_full_64():
    dc, ac = _simple_tables()
    # Fill all 63 AC slots with (run=0,size=1) codes: "01" + bit.
    stream = _bits_to_bytes("00 " + "01 1 " * 63)
    block = next_block(BitReader(stream), ac, dc)
    assert block[0] == 0
    assert (block[1:] == 1).all()


def test_decode_symbol_invalid_prefix_raises():
    # Table with the single code "0"; a peek starting with bit 1 is invalid.
    t = HuffmanTable.from_bits_values([1] + [0] * 15, [7])
    with np.testing.assert_raises(ValueError):
        decode_symbol(BitReader(np.array([0xFF] * 5, dtype=np.uint8)), t)


def test_zrl_capped_at_block_end():
    dc, ac = _simple_tables()
    # 60 coefficients of 1, then ZRL (only 3 slots left -> capped), block full.
    stream = _bits_to_bytes("00 " + "01 1 " * 60 + "100")
    block = next_block(BitReader(stream), ac, dc)
    assert (block[1:61] == 1).all()
    assert (block[61:] == 0).all()


@pytest.mark.parametrize("name", ["gray-nort", "420-nort", "422-nort",
                                  "444-nort"])
def test_decode_with_offsets_bookkeeping(stream_corpus, name):
    """Block-start bit offsets are strictly increasing and stay within the
    segment (debug API for cursor validation). Single-segment streams: the
    offsets restart at every restart marker."""
    from jpeg_tpu.entropy.oracle import decode_coefficients, decode_coefficients_with_offsets
    from jpeg_tpu.io.container import parse_jpeg

    plan = parse_jpeg(stream_corpus[name])
    coeffs, offsets = decode_coefficients_with_offsets(plan)
    np.testing.assert_array_equal(coeffs, decode_coefficients(plan))
    assert (np.diff(offsets) > 0).all()
    assert offsets[0] == 0
    assert offsets[-1] < plan.scan_data.size * 8
