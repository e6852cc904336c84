"""C++ runtime equivalence tests vs the NumPy oracle."""

import numpy as np
import pytest

from conftest import STREAMS
from jpeg_tpu.entropy.oracle import decode_coefficients
from jpeg_tpu.io.container import parse_jpeg
from jpeg_tpu.runtime import (
    NativeDecodeError,
    native_available,
    native_decode_coefficients,
)

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native runtime not built"
)


@pytest.mark.parametrize("name", list(STREAMS))
def test_native_matches_oracle_corpus(name, stream_corpus):
    plan = parse_jpeg(stream_corpus[name])
    np.testing.assert_array_equal(
        native_decode_coefficients(plan), decode_coefficients(plan)
    )


def test_native_matches_oracle_restart_streams():
    """Random restart-interval streams from our encoder."""
    from jpeg_tpu.models.encoder import encode_rgb

    rng = np.random.default_rng(0)
    for trial, (size, ri) in enumerate([((48, 80), 1), ((64, 64), 3), ((40, 56), 7)]):
        img = rng.integers(0, 256, size + (3,), dtype=np.uint8)
        data = encode_rgb(img, quality=75, subsampling=(2, 1),
                          restart_interval_mcus=ri)
        plan = parse_jpeg(data)
        assert len(plan.segments) > 1
        np.testing.assert_array_equal(
            native_decode_coefficients(plan), decode_coefficients(plan)
        )


def test_native_single_thread_matches_multi(stream_corpus):
    plan = parse_jpeg(stream_corpus["420"])
    np.testing.assert_array_equal(
        native_decode_coefficients(plan, n_threads=1),
        native_decode_coefficients(plan, n_threads=4),
    )


def test_native_error_isolation(stream_corpus):
    """Corrupt entropy data raises NativeDecodeError with segment index."""
    plan = parse_jpeg(stream_corpus["gray-nort"])
    # Build a table set where every prefix is invalid by zeroing the LUTs.
    bad = parse_jpeg(stream_corpus["gray-nort"])
    for t in bad.dc_tables:
        t.lut_length = np.zeros_like(t.lut_length)
    with pytest.raises(NativeDecodeError) as ei:
        native_decode_coefficients(bad)
    assert ei.value.segment == 0
    # Original plan still decodes fine (no shared state).
    native_decode_coefficients(plan)


def test_reused_buffer_bulk_prezero_clears_previous_frame():
    """prezero=2 contract: decoding image B into the per-thread buffer that
    just held image A (dense coefficients) must equal a fresh decode of B —
    the bulk zero phase, not per-tile memsets, clears A's residue."""
    from jpeg_tpu.io.corpus import synthetic_image
    from jpeg_tpu.models.encoder import encode_rgb
    from jpeg_tpu.runtime import native_decode_planes

    rng = np.random.default_rng(3)
    # A: noisy image -> dense nonzero coefficients everywhere.
    a = parse_jpeg(encode_rgb(
        rng.integers(0, 256, (96, 128, 3), dtype=np.uint8), quality=95,
        restart_interval_mcus=2))
    # B: flat image -> almost all-zero AC; stale residue would show.
    b = parse_jpeg(encode_rgb(
        np.full((96, 128, 3), 100, np.uint8), quality=95,
        restart_interval_mcus=2))
    fresh = [x.copy() for x in native_decode_planes(b, reuse_buffer=False)]
    native_decode_planes(a)  # dirty the reused buffer
    reused = native_decode_planes(b)
    for f, r in zip(fresh, reused):
        np.testing.assert_array_equal(f, np.asarray(r))
    # Same through the speculative path (single-segment stream).
    a2 = parse_jpeg(encode_rgb(
        rng.integers(0, 256, (96, 128, 3), dtype=np.uint8), quality=95))
    b2 = parse_jpeg(encode_rgb(np.full((96, 128, 3), 100, np.uint8),
                               quality=95))
    fresh2 = [x.copy() for x in native_decode_planes(
        b2, reuse_buffer=False, speculative=True)]
    native_decode_planes(a2, speculative=True)
    reused2 = native_decode_planes(b2, speculative=True)
    for f, r in zip(fresh2, reused2):
        np.testing.assert_array_equal(f, np.asarray(r))
