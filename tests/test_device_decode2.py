"""Device v2 (register-refill multi-symbol) entropy decoder: equivalence
vs the oracle, same matrix as test_device_decode.py (SURVEY.md §7 layer 4:
"Equivalence-test against layer 2 on random streams")."""

import numpy as np
import pytest

from jpeg_tpu.entropy.device_decode2 import (
    decode_coefficients_device2,
    decode_coefficients_device2_batch,
)
from jpeg_tpu.entropy.oracle import decode_coefficients
from jpeg_tpu.io.container import parse_jpeg
from jpeg_tpu.models.encoder import encode_rgb


@pytest.mark.parametrize(
    "sub,ri,size",
    [
        ((1, 1), 1, (32, 48)),
        ((2, 1), 2, (48, 64)),
        ((2, 2), 3, (64, 80)),
        ((2, 2), 1, (40, 56)),
        ((1, 2), 2, (48, 48)),
    ],
)
def test_matches_oracle_restart_streams(sub, ri, size):
    rng = np.random.default_rng(hash((sub, ri)) % 2**31)
    img = rng.integers(0, 256, size + (3,), dtype=np.uint8)
    data = encode_rgb(img, quality=80, subsampling=sub,
                      restart_interval_mcus=ri)
    plan = parse_jpeg(data)
    assert len(plan.segments) > 1
    got, err = decode_coefficients_device2(plan)
    assert not np.asarray(err).any()
    np.testing.assert_array_equal(np.asarray(got), decode_coefficients(plan))


def test_matches_oracle_no_restarts():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    data = encode_rgb(img, quality=80, subsampling=(1, 1))
    plan = parse_jpeg(data)
    assert len(plan.segments) == 1
    got, err = decode_coefficients_device2(plan)
    assert not np.asarray(err).any()
    np.testing.assert_array_equal(np.asarray(got), decode_coefficients(plan))


def test_matches_oracle_reference_corpus(stream_corpus):
    """A stream without restart markers, like the reference corpus."""
    plan = parse_jpeg(stream_corpus["444-nort"])
    got, err = decode_coefficients_device2(plan)
    assert not np.asarray(err).any()
    np.testing.assert_array_equal(np.asarray(got), decode_coefficients(plan))


def test_invalid_prefix_sets_error_flag():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    data = encode_rgb(img, quality=80, subsampling=(1, 1),
                      restart_interval_mcus=1)
    plan = parse_jpeg(data)
    import jax.numpy as jnp

    from jpeg_tpu.entropy.device_decode import packed_luts

    # Zero out the LUTs: every prefix invalid -> all segments flag errors.
    luts = packed_luts(plan)
    luts[:, :] = 0
    _, err = decode_coefficients_device2(plan, luts=jnp.asarray(luts))
    assert np.asarray(err).all()


def test_grayscale_stream():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (40, 40), dtype=np.uint8)
    data = encode_rgb(img, quality=85, restart_interval_mcus=2)
    plan = parse_jpeg(data)
    got, err = decode_coefficients_device2(plan)
    assert not np.asarray(err).any()
    np.testing.assert_array_equal(np.asarray(got), decode_coefficients(plan))


def test_matches_oracle_optimized_tables():
    """Per-image optimal Huffman tables (non-Annex-K) — exercises LUT
    generality through the register-refill path."""
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    data = encode_rgb(img, quality=80, subsampling=(2, 1),
                      restart_interval_mcus=2, optimize=True)
    plan = parse_jpeg(data)
    got, err = decode_coefficients_device2(plan)
    assert not np.asarray(err).any()
    np.testing.assert_array_equal(np.asarray(got), decode_coefficients(plan))


def test_batched_corpus_matches_oracle():
    from jpeg_tpu.io.corpus import synthetic_jpeg

    plans = [parse_jpeg(synthetic_jpeg(160, 96, seed=i, restart_rows=1))
             for i in range(3)]
    outs, err = decode_coefficients_device2_batch(plans)
    assert not bool(np.asarray(err).any())
    for p, o in zip(plans, outs):
        np.testing.assert_array_equal(np.asarray(o), decode_coefficients(p))


def test_batched_corpus_mixed_restart_intervals():
    from jpeg_tpu.io.corpus import synthetic_jpeg

    plans = [parse_jpeg(synthetic_jpeg(160, 96, seed=7, restart_rows=1)),
             parse_jpeg(synthetic_jpeg(160, 96, seed=8, restart_rows=2))]
    assert plans[0].segments[0].mcu_count != plans[1].segments[0].mcu_count
    outs, err = decode_coefficients_device2_batch(plans)
    assert not bool(np.asarray(err).any())
    for p, o in zip(plans, outs):
        np.testing.assert_array_equal(np.asarray(o), decode_coefficients(p))


def test_batched_corpus_rejects_mismatched_tables():
    from jpeg_tpu.io.corpus import synthetic_image, synthetic_jpeg

    a = parse_jpeg(synthetic_jpeg(160, 96, seed=1, restart_rows=1))
    b = parse_jpeg(encode_rgb(synthetic_image(160, 96, seed=2),
                              restart_interval_mcus=4, optimize=True))
    with pytest.raises(ValueError, match="identical"):
        decode_coefficients_device2_batch([a, b])
