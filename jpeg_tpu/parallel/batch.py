"""Sharded batch decode: the scale-out decode step.

Design (SURVEY.md §5 "long-context" mapping): a batch of same-geometry images
is the common production case (e.g. a 10k-image 4K corpus). Coefficients are
sharded over the ``data`` mesh axis; each device runs the fused
dequant+IDCT+assembly+color pipeline on its shard; the only cross-device
traffic is a ``psum`` of per-device metrics (frames, blocks, bytes) — decode
itself needs no collectives, which is what makes >=80%% scaling achievable.

Within-image segment parallelism (``seg`` axis) lives in
:mod:`jpeg_tpu.entropy.device_decode`; the combination is exercised by
``__graft_entry__.dryrun_multichip``.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jpeg_tpu.models.decoder import PipelineGeometry, _pipeline


def _batched_pipeline(coeffs, matrices, geom: PipelineGeometry, rounding: str):
    """[B, total_blocks, 64] x [B, ncomp, 64, 64] -> [B, H, W, 3] u8."""
    fn = partial(_pipeline, geom=geom, rounding=rounding)
    return jax.vmap(fn)(coeffs, matrices)


@lru_cache(maxsize=64)
def _compiled_batch(geom: PipelineGeometry, rounding: str, mesh: Mesh | None):
    def step(coeffs, matrices):
        rgb = _batched_pipeline(coeffs, matrices, geom, rounding)
        return rgb

    if mesh is None:
        return jax.jit(step)

    in_shard = NamedSharding(mesh, P("data"))
    out_shard = NamedSharding(mesh, P("data"))
    return jax.jit(step, in_shardings=(in_shard, in_shard), out_shardings=out_shard)


def decode_batch(coeffs, matrices, geom: PipelineGeometry,
                 rounding: str = "truncate", mesh: Mesh | None = None):
    """Decode a same-geometry batch, optionally sharded over ``mesh``'s data
    axis. coeffs [B, total_blocks, 64] i32; matrices [B, ncomp, 64, 64] f32."""
    fn = _compiled_batch(geom, rounding, mesh)
    return fn(jnp.asarray(coeffs), jnp.asarray(matrices))


def decode_batch_with_metrics(coeffs, matrices, geom: PipelineGeometry,
                              mesh: Mesh, rounding: str = "truncate"):
    """shard_map variant that also psums per-device metrics over the mesh —
    the collective pattern multi-host runs use for frames/s accounting
    (SURVEY.md §5 distributed backend mapping)."""
    def shard_step(coeffs_s, matrices_s):
        rgb = _batched_pipeline(coeffs_s, matrices_s, geom, rounding)
        frames = jax.lax.psum(
            jnp.asarray(coeffs_s.shape[0], jnp.int32), axis_name="data")
        blocks = jax.lax.psum(
            jnp.asarray(coeffs_s.shape[0] * geom.total_blocks, jnp.int32),
            axis_name="data")
        return rgb, frames, blocks

    fn = shard_map(
        shard_step,
        mesh=mesh,
        in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P(), P()),
    )
    return jax.jit(fn)(jnp.asarray(coeffs), jnp.asarray(matrices))


def decode_batch_fast(planes_batch, q_batch, geom: PipelineGeometry,
                      rounding: str = "truncate", mesh: Mesh | None = None,
                      idct_mode: str = "exact"):
    """Batched plane path: the pixel stage (:mod:`jpeg_tpu.ops.pixel`)
    mapped over a batch, optionally sharded over the ``data`` mesh axis.

    ``planes_batch``: per-component [B, rows_c, stride_c] int16;
    ``q_batch``: [B, ncomp, 8, 8] f32 natural-order dequant tables.
    Returns [B, H, W, 3] u8. ``idct_mode="approx"`` runs the IDCT at
    DEFAULT precision (quality: docs/APPROX_QUALITY.md).
    """
    from jpeg_tpu.ops.pixel import planes_to_rgb_fn

    fn = planes_to_rgb_fn(geom, rounding, idct_mode, batched=True)
    planes = [jnp.asarray(p) for p in planes_batch]
    q = jnp.asarray(q_batch)
    if mesh is not None:
        shard = NamedSharding(mesh, P("data"))
        planes, q = jax.device_put((planes, q), shard)
    return fn(planes, q)


def decode_batch_rows_sp(coeffs, matrices, geom: PipelineGeometry, mesh: Mesh,
                         rounding: str = "truncate"):
    """Batch decode sharded over BOTH mesh axes: images over ``data`` and MCU
    rows of each image over ``seg`` (the sequence-parallel analogue from the
    north star: "shard MCU rows / images across chips").

    JPEG MCU rows are independent in pixel space — chroma upsampling never
    crosses an MCU-row boundary — so each seg shard decodes a horizontal band
    with a *local* pipeline geometry and the output stays row-sharded; the
    only collective is the metrics psum. Requires ``mcus_y %% n_seg == 0`` and
    no partial bottom MCU row (pad images otherwise).
    """
    n_seg = mesh.shape["seg"]
    if geom.mcus_y % n_seg or geom.height != geom.mcus_y * 8 * geom.v_max:
        raise ValueError(
            f"row sharding needs mcus_y ({geom.mcus_y}) divisible by n_seg "
            f"({n_seg}) and full MCU rows (height {geom.height})"
        )
    local = dataclasses.replace(
        geom, mcus_y=geom.mcus_y // n_seg, height=geom.height // n_seg
    )
    def shard_step(coeffs_s, matrices_s):
        rgb = _batched_pipeline(coeffs_s, matrices_s, local, rounding)
        frames = jax.lax.psum(
            jnp.asarray(coeffs_s.shape[0], jnp.int32), axis_name="data")
        return rgb, frames

    fn = shard_map(
        shard_step,
        mesh=mesh,
        # coeffs stream order is MCU-row-major, so an even split of the block
        # axis over "seg" is exactly an MCU-row-band split.
        in_specs=(P("data", "seg"), P("data")),
        out_specs=(P("data", "seg"), P()),
    )
    return jax.jit(fn)(jnp.asarray(coeffs), jnp.asarray(matrices))


def decode_batch_rows_sp_fast(planes_batch, q_batch,
                              geom: PipelineGeometry, mesh: Mesh,
                              rounding: str = "truncate"):
    """Plane-path batch decode sharded over BOTH axes: images over
    ``data``, horizontal plane bands over ``seg``.

    Coefficient planes slice cleanly along MCU rows (bands are
    independent), so each seg shard runs the pixel stage with a local
    geometry and the u8 output stays row-sharded — no collectives in the
    decode itself. Same constraints as :func:`decode_batch_rows_sp`.
    """
    from jpeg_tpu.ops.pixel import planes_to_rgb

    n_seg = mesh.shape["seg"]
    if geom.mcus_y % n_seg or geom.height != geom.mcus_y * 8 * geom.v_max:
        raise ValueError(
            f"row sharding needs mcus_y ({geom.mcus_y}) divisible by n_seg "
            f"({n_seg}) and full MCU rows (height {geom.height})"
        )
    local = dataclasses.replace(
        geom, mcus_y=geom.mcus_y // n_seg, height=geom.height // n_seg
    )
    fn = jax.vmap(partial(planes_to_rgb, geom=local, rounding=rounding))
    shard = shard_map(
        fn,
        mesh=mesh,
        # planes: [B, rows_c, cols_c] -> batch over data, rows over seg;
        # dequant tables replicated over seg.
        in_specs=([P("data", "seg", None)] * len(planes_batch),
                  P("data", None, None, None)),
        out_specs=P("data", "seg", None, None),
    )
    return jax.jit(shard)([jnp.asarray(p) for p in planes_batch],
                          jnp.asarray(q_batch))


def encode_batch_device(rgb_planar_batch, inv_q_batch,
                        geom: PipelineGeometry, mesh: Mesh | None = None):
    """Batched device forward transform (the encoder's dense half):
    :func:`jpeg_tpu.ops.pixel.forward_planes` mapped over a batch,
    optionally sharded over ``data``.

    ``rgb_planar_batch``: [B, 3|1, H, W] u8 planar;
    ``inv_q_batch``: [B, ncomp, 8, 8] f32 reciprocal quant tables. Returns
    per-component int16 coefficient planes [B, rows_c, stride_c] ready for
    the parallel entropy encoder.
    """
    from jpeg_tpu.ops.pixel import forward_planes_fn

    args = (jnp.asarray(rgb_planar_batch), jnp.asarray(inv_q_batch))
    if mesh is not None:
        args = jax.device_put(args, NamedSharding(mesh, P("data")))
    return forward_planes_fn(geom, batched=True)(*args)
