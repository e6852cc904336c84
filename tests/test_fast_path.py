"""Fast decode path (plane-layout C++ entropy + the plain-JAX pixel stage).

Contract: within +-1 u8 of the bit-exact compat path (float summation order
differs in the separable IDCT), identical shapes, high PSNR.
"""

import numpy as np
import pytest

from conftest import STREAMS, psnr
from jpeg_tpu.io.container import parse_jpeg
from jpeg_tpu.models.decoder import decode_bytes
from jpeg_tpu.models.encoder import encode_rgb
from jpeg_tpu.runtime import native_available, native_decode_planes, plane_shapes

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native runtime not built"
)


@pytest.mark.parametrize("name", list(STREAMS))
def test_fast_within_one_of_compat(name, stream_corpus):
    compat = decode_bytes(stream_corpus[name], rounding="truncate")
    fast = decode_bytes(stream_corpus[name], rounding="truncate", path="fast")
    assert fast.shape == compat.shape
    diff = np.abs(fast.astype(int) - compat.astype(int))
    assert diff.max() <= 1
    # Differences must be rare rounding flips, not structural.
    assert (diff > 0).mean() < 0.05


def test_fast_path_restart_roundtrip():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (56, 72, 3), dtype=np.uint8)
    data = encode_rgb(img, quality=90, subsampling=(2, 2), restart_interval_mcus=2)
    fast = decode_bytes(data, rounding="round", path="fast")
    compat = decode_bytes(data, rounding="round")
    # 4:2:0 on pure noise loses a lot in the encoder (that's expected); the
    # decode paths themselves must agree to +-1.
    assert np.abs(fast.astype(int) - compat.astype(int)).max() <= 1


def test_plane_shapes_alignment(stream_corpus):
    """The C++ runtime's plane shapes are the pixel stage's layout: whole
    MCUs per component, no further padding."""
    from jpeg_tpu.models.decoder import PipelineGeometry
    from jpeg_tpu.ops.pixel import geometry_plane_shapes

    for name, data in stream_corpus.items():
        plan = parse_jpeg(data)
        geom = PipelineGeometry.of(plan)
        assert plane_shapes(plan) == geometry_plane_shapes(geom), name
        assert plane_shapes(plan) == [
            (plan.mcus_y * c.v * 8, plan.mcus_x * c.h * 8)
            for c in plan.components], name


@pytest.mark.parametrize("name", ["422", "420-nort", "gray"])
def test_plane_entropy_matches_stream_layout(name, stream_corpus):
    """C++ plane output == numpy-converted stream output (de-zigzag + place)."""
    from jpeg_tpu.ops.zigzag import ZIGZAG_INDICES
    from jpeg_tpu.runtime import native_decode_coefficients

    plan = parse_jpeg(stream_corpus[name])
    coeffs = native_decode_coefficients(plan, reuse_buffer=False)
    planes = native_decode_planes(plan)
    shapes = plane_shapes(plan)
    want = [np.zeros(s, np.int16) for s in shapes]
    slots = plan.component_block_slots()
    bi = 0
    for mcu in range(plan.n_mcus):
        my, mx = divmod(mcu, plan.mcus_x)
        for ci, sub in slots:
            c = plan.components[ci]
            vi, hi = divmod(sub, c.h)
            by, bx = my * c.v + vi, mx * c.h + hi
            nat = np.zeros(64, np.int32)
            nat[ZIGZAG_INDICES] = coeffs[bi]
            want[ci][by * 8 : by * 8 + 8, bx * 8 : bx * 8 + 8] = nat.reshape(8, 8)
            bi += 1
    for g, w in zip(planes, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("sub", [(4, 1), (1, 4), (4, 4)])
def test_sampling_factor_four(sub):
    """h/v sampling factors up to 4 (beyond the reference's 1/2 limit,
    src/jpeg/mod.rs:275-277) work on both decode paths."""
    from jpeg_tpu.io.corpus import synthetic_image

    img = synthetic_image(128, 64, seed=4)
    data = encode_rgb(img, quality=90, subsampling=sub, restart_interval_mcus=2)
    compat = decode_bytes(data, rounding="round")
    fast = decode_bytes(data, rounding="round", path="fast")
    assert np.abs(fast.astype(int) - compat.astype(int)).max() <= 1
    assert psnr(compat, img) > 25.0


def test_sampling_factor_three_rejected():
    from jpeg_tpu.io.container import JPEGError
    from jpeg_tpu.io.corpus import synthetic_image

    img = synthetic_image(64, 64, seed=5)
    data = encode_rgb(img, quality=90, subsampling=(3, 1))
    with pytest.raises(JPEGError, match="sampling"):
        decode_bytes(data)


@pytest.mark.parametrize("shape", [(1, 1), (1, 8), (3, 5), (9, 17)])
def test_tiny_images_both_paths(shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    data = encode_rgb(img, quality=90, subsampling=(2, 2))
    compat = decode_bytes(data)
    fast = decode_bytes(data, path="fast")
    assert compat.shape == img.shape == fast.shape
    assert np.abs(compat.astype(int) - fast.astype(int)).max() <= 1


def test_idct_mode_approx_path(stream_corpus):
    """idct_mode="approx" (DEFAULT-precision IDCT) decodes through the same
    pixel stage; on the CPU DEFAULT == exact f32, so outputs match. The
    GPU's error (TF32) is measured by chip_smoke.py and recorded in
    docs/APPROX_QUALITY.md."""
    import jpeg_tpu

    data = stream_corpus["422"]
    a = jpeg_tpu.decode_bytes(data, path="fast")
    b = jpeg_tpu.decode_bytes(data, path="fast", idct_mode="approx")
    assert a.shape == b.shape
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 2
