"""Sharded batch decode tests on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

import jax

from jpeg_tpu.io.container import parse_jpeg
from jpeg_tpu.models.decoder import (
    PipelineGeometry,
    decode_bytes,
    decode_coefficients_host,
    plan_matrices,
)
from jpeg_tpu.parallel.batch import (
    decode_batch,
    decode_batch_rows_sp,
    decode_batch_with_metrics,
)
from jpeg_tpu.parallel.mesh import make_mesh


def _seeded_jpeg(width, height, subsampling=(2, 2), seed=0):
    from jpeg_tpu.io.corpus import synthetic_image
    from jpeg_tpu.models.encoder import encode_rgb

    return encode_rgb(synthetic_image(width, height, seed), quality=85,
                      subsampling=subsampling, restart_interval_mcus=2)


@pytest.fixture(scope="module")
def lena_batch():
    """A batch of one seeded 4:2:2 image with lena's sampling (full MCU
    rows, mcus_y divisible by the seg axis)."""
    data = _seeded_jpeg(128, 64, subsampling=(2, 1))
    plan = parse_jpeg(data)
    coeffs = decode_coefficients_host(plan)
    geom = PipelineGeometry.of(plan)
    B = 8
    cb = np.broadcast_to(coeffs, (B,) + coeffs.shape).copy()
    mb = np.broadcast_to(plan_matrices(plan), (B, 3, 64, 64)).copy()
    single = decode_bytes(data)
    return geom, cb, mb, np.asarray(single)


def test_mesh_shape():
    mesh = make_mesh(n_data=4, n_seg=2)
    assert mesh.shape == {"data": 4, "seg": 2}


def test_batch_matches_single(lena_batch):
    geom, cb, mb, single = lena_batch
    out = np.asarray(decode_batch(cb, mb, geom))
    assert out.shape[0] == 8
    for i in range(8):
        np.testing.assert_array_equal(out[i], single)


def test_batch_sharded_matches_single(lena_batch):
    geom, cb, mb, single = lena_batch
    mesh = make_mesh(n_data=8, n_seg=1)
    out = np.asarray(decode_batch(cb, mb, geom, mesh=mesh))
    for i in range(8):
        np.testing.assert_array_equal(out[i], single)


def test_batch_metrics_psum(lena_batch):
    geom, cb, mb, single = lena_batch
    mesh = make_mesh(n_data=8, n_seg=1)
    out, frames, blocks = decode_batch_with_metrics(cb, mb, geom, mesh)
    assert int(frames) == 8
    assert int(blocks) == 8 * geom.total_blocks
    np.testing.assert_array_equal(np.asarray(out)[3], single)


def test_rows_sp_matches_single(lena_batch):
    """Images over data axis AND MCU rows over seg axis."""
    geom, cb, mb, single = lena_batch
    mesh = make_mesh(n_data=4, n_seg=2)
    out, frames = decode_batch_rows_sp(cb[:4], mb[:4], geom, mesh)
    assert int(frames) == 4
    out = np.asarray(out)
    for i in range(4):
        np.testing.assert_array_equal(out[i], single)


def test_rows_sp_rejects_bad_geometry(lena_batch):
    geom, cb, mb, _ = lena_batch
    mesh = make_mesh(n_data=2, n_seg=4)
    import dataclasses

    bad = dataclasses.replace(geom, mcus_y=geom.mcus_y - 1)
    with pytest.raises(ValueError, match="row sharding"):
        decode_batch_rows_sp(cb[:2], mb[:2], bad, mesh)


def test_graft_entry_dryrun():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (128, 128, 3)
    ge.dryrun_multichip(8)


def _plane_batch(data, batch):
    from jpeg_tpu.ops.pixel import plan_quant_tables
    from jpeg_tpu.runtime import native_decode_planes

    plan = parse_jpeg(data)
    planes = [np.asarray(p).copy() for p in native_decode_planes(plan)]
    q = plan_quant_tables(plan)
    bp = [np.broadcast_to(p, (batch,) + p.shape).copy() for p in planes]
    bq = np.broadcast_to(q, (batch,) + q.shape).copy()
    return PipelineGeometry.of(plan), planes, q, bp, bq


def test_batch_fast_path_sharded():
    """Batched plane path sharded over the data axis: every shard equals
    the one-image decode, and the output is [B, H, W, 3] on 8 devices."""
    from jpeg_tpu.parallel.batch import decode_batch_fast

    data = _seeded_jpeg(128, 96)
    geom, planes, q, bp, bq = _plane_batch(data, 8)
    mesh = make_mesh(n_data=8, n_seg=1)
    out = decode_batch_fast(bp, bq, geom, mesh=mesh)
    assert len({s.device for s in out.addressable_shards}) == 8
    out = np.asarray(out)
    single = np.asarray(decode_batch_fast([p[None] for p in planes],
                                          q[None], geom))[0]
    assert out.shape == (8, 96, 128, 3)
    np.testing.assert_array_equal(single, decode_bytes(data, path="fast"))
    for i in range(8):
        np.testing.assert_array_equal(out[i], single)


def test_data_sharding_helper():
    from jpeg_tpu.parallel.mesh import data_sharding

    mesh = make_mesh(n_data=4, n_seg=2)
    sh = data_sharding(mesh, rank=3, axis=0)
    assert sh.spec == jax.sharding.PartitionSpec("data", None, None)


def test_rows_sp_fast_matches_single():
    """Plane path sharded over (data, seg): bands of the coefficient planes
    decode independently per device."""
    from jpeg_tpu.parallel.batch import decode_batch_fast, decode_batch_rows_sp_fast

    # mcus_y must be divisible by n_seg, with full MCU rows (4:2:0).
    data = _seeded_jpeg(96, 64, seed=5)  # H = 64 -> mcus_y = 4
    geom, planes, q, bp, bq = _plane_batch(data, 4)
    B = 4
    mesh = make_mesh(n_data=4, n_seg=2)
    out = np.asarray(decode_batch_rows_sp_fast(bp, bq, geom, mesh))
    single = np.asarray(decode_batch_fast(
        [p[None] for p in planes], q[None], geom))[0]
    assert out.shape[0] == B
    for i in range(B):
        np.testing.assert_array_equal(out[i], single)


def test_encode_batch_device_sharded():
    """Batched device forward transform matches the single-image encoder."""
    from jpeg_tpu.io.corpus import synthetic_image
    from jpeg_tpu.models.decoder import PipelineGeometry
    from jpeg_tpu.ops.pixel import forward_planes_fn, inverse_quant_tables
    from jpeg_tpu.entropy.annex_k import scaled_quant_table, QUANT_CHROMA, QUANT_LUMA
    from jpeg_tpu.parallel.batch import encode_batch_device

    img = synthetic_image(128, 96, seed=91)
    geom = PipelineGeometry(
        width=128, height=96, mcus_x=8, mcus_y=6, h_max=2, v_max=2,
        sampling=((2, 2), (1, 1), (1, 1)),
    )
    planar = img.transpose(2, 0, 1)
    q = [scaled_quant_table(QUANT_LUMA, 85),
         scaled_quant_table(QUANT_CHROMA, 85),
         scaled_quant_table(QUANT_CHROMA, 85)]
    iq = inverse_quant_tables(q)
    single = forward_planes_fn(geom)(planar, iq)
    B = 4
    bp = np.broadcast_to(planar, (B,) + planar.shape).copy()
    bq = np.broadcast_to(iq, (B,) + iq.shape).copy()
    mesh = make_mesh(n_data=4, n_seg=1)
    out = encode_batch_device(bp, bq, geom, mesh=mesh)
    for c in range(3):
        for b in range(B):
            np.testing.assert_array_equal(
                np.asarray(out[c][b]), np.asarray(single[c]))
