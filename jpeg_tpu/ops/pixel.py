"""The plane pixel stage: int16 coefficient planes <-> u8 pixels, plain JAX.

The C++ entropy tier (``jpeg_tpu.runtime.native_decode_planes``) writes each
component's quantized coefficients de-zigzagged into one natural-order int16
plane, so the block-stream relayout of the compat pipeline
(:mod:`jpeg_tpu.models.decoder`) never happens. What is left is dense and
memory-bound (about 2 B in and 3 B out per pixel):

- dequantise (elementwise, natural-order 8x8 table broadcast over blocks);
- the separable 8x8 IDCT as two 8-point contractions over a
  ``[rows/8, 8, cols/8, 8]`` view of the plane;
- chroma upsample by broadcast + reshape (pixel replication);
- YCbCr->RGB in the reference's operation order, clamp, u8.

:func:`forward_planes` is the inverse (the encoder's dense half).

Plane layout. This module owns it; the C++ runtime reads it through
:func:`plane_shapes`. Component ``c`` with sampling ``(h, v)`` is one
``[mcus_y * v * 8, mcus_x * h * 8]`` plane: whole MCUs, no further padding,
block ``(by, bx)`` at rows ``8*by..`` and columns ``8*bx..``.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from jpeg_tpu.ops.color import grayscale_to_rgb, ycbcr_to_rgb
from jpeg_tpu.ops.idct import dct_basis_1d
from jpeg_tpu.ops.upsample import upsample_replicate
from jpeg_tpu.ops.zigzag import unzigzag

_PRECISION = {"exact": jax.lax.Precision.HIGHEST,
              "approx": jax.lax.Precision.DEFAULT}


def plane_shapes(mcus_x: int, mcus_y: int,
                 sampling) -> list[tuple[int, int]]:
    """[rows, stride] of each component's coefficient plane (see module
    docstring). ``sampling``: (h, v) per component, scan order."""
    return [(mcus_y * v * 8, mcus_x * h * 8) for h, v in sampling]


def geometry_plane_shapes(geom) -> list[tuple[int, int]]:
    """:func:`plane_shapes` of a :class:`~jpeg_tpu.models.decoder.PipelineGeometry`."""
    return plane_shapes(geom.mcus_x, geom.mcus_y, geom.sampling)


def plane_path_supported(geom) -> bool:
    """Whether :func:`planes_to_rgb` can decode this geometry: 8-bit YCbCr
    or gray with integral chroma factors (everything else takes the compat
    pipeline, which handles every color model and precision)."""
    return (geom.precision == 8
            and geom.color_model in ("ycbcr", "gray")
            and len(geom.sampling) in (1, 3)
            and all(geom.h_max % h == 0 and geom.v_max % v == 0
                    for h, v in geom.sampling))


def plan_quant_tables(plan) -> np.ndarray:
    """[ncomp, 8, 8] f32 natural-order dequant tables, component order."""
    return np.stack([
        unzigzag(np.asarray(plan.quant_tables[c.quant_id],
                            dtype=np.float32).reshape(64)).reshape(8, 8)
        for c in plan.components
    ])


def inverse_quant_tables(quant_zz) -> np.ndarray:
    """Zigzag-order quant table per component -> [ncomp, 8, 8] f32
    reciprocals in natural order (the ``inv_q`` of :func:`forward_planes`)."""
    return np.stack([
        1.0 / unzigzag(np.asarray(q, dtype=np.float32).reshape(64)).reshape(8, 8)
        for q in quant_zz
    ]).astype(np.float32)


def _basis():
    return jnp.asarray(dct_basis_1d(), jnp.float32)  # A[u, x]


def idct_plane(plane, q88, precision=jax.lax.Precision.HIGHEST):
    """int16 plane [R, C] x natural-order table [8, 8] -> f32 centered
    samples [R, C]: out[8a+i, 8b+j] = sum_uv A[u,i] A[v,j] q[u,v] F[8a+u, 8b+v]."""
    r, c = plane.shape
    a = _basis()
    f = plane.astype(jnp.float32).reshape(r // 8, 8, c // 8, 8) * q88[:, None, :]
    t = jnp.einsum("aubv,ui->aibv", f, a, precision=precision)
    s = jnp.einsum("aibv,vj->aibj", t, a, precision=precision)
    return s.reshape(r, c)


def planes_to_rgb(planes, q, geom, rounding: str = "truncate",
                  idct_mode: str = "exact"):
    """Per-component int16 planes (:func:`plane_shapes` layout) and
    [ncomp, 8, 8] dequant tables -> [H, W, 3] u8. Pure function of arrays;
    jit and vmap it (:func:`planes_to_rgb_fn`)."""
    precision = _PRECISION[idct_mode]
    full = []
    for ci, (h, v) in enumerate(geom.sampling):
        s = idct_plane(planes[ci], q[ci], precision)
        s = upsample_replicate(s, geom.v_max // v, geom.h_max // h)
        full.append(s[: geom.height, : geom.width])
    if len(full) == 1:
        return grayscale_to_rgb(full[0], rounding)
    return ycbcr_to_rgb(full[0], full[1], full[2], rounding)


@lru_cache(maxsize=256)
def planes_to_rgb_fn(geom, rounding: str = "truncate",
                     idct_mode: str = "exact", batched: bool = False):
    """Jitted :func:`planes_to_rgb` for one geometry: ``fn(planes, q)``.
    ``batched`` maps it over a leading batch axis of every argument."""
    def fn(planes, q):
        return planes_to_rgb(planes, q, geom, rounding, idct_mode)

    return jax.jit(jax.vmap(fn) if batched else fn)


def decode_planes(planes, plan, rounding: str = "truncate",
                  idct_mode: str = "exact"):
    """int16 coefficient planes of one image -> [H, W, 3] u8 (device)."""
    from jpeg_tpu.models.decoder import PipelineGeometry

    geom = PipelineGeometry.of(plan)
    fn = planes_to_rgb_fn(geom, rounding, idct_mode)
    return fn([jnp.asarray(p) for p in planes],
              jnp.asarray(plan_quant_tables(plan)))


def _pad_edge(x, rows: int, cols: int):
    return jnp.pad(x, ((0, rows - x.shape[0]), (0, cols - x.shape[1])),
                   mode="edge")


def _downsample(x, fy: int, fx: int):
    """Box mean over fy x fy blocks, the edge replicated to whole blocks
    first (the host encoder's order, ``models/encoder._forward_transform``)."""
    if fy == fx == 1:
        return x
    r, c = -(-x.shape[0] // fy) * fy, -(-x.shape[1] // fx) * fx
    x = _pad_edge(x, r, c)
    return x.reshape(r // fy, fy, c // fx, fx).mean(axis=(1, 3))


def forward_planes(rgb_planar, inv_q, geom):
    """Encoder's dense half. ``rgb_planar``: [3|1, H, W] u8; ``inv_q``:
    [ncomp, 8, 8] f32 reciprocal natural-order quant tables. Returns the
    quantized int16 coefficient planes (:func:`plane_shapes` layout), each
    component downsampled, then edge-padded to whole MCUs."""
    x = rgb_planar.astype(jnp.float32)
    if len(geom.sampling) == 1:
        comps = [x[0] - 128.0]
    else:
        r, g, b = x[0], x[1], x[2]
        comps = [0.299 * r + 0.587 * g + 0.114 * b - 128.0,
                 -0.168735892 * r - 0.331264108 * g + 0.5 * b,
                 0.5 * r - 0.418687589 * g - 0.081312411 * b]
    a = _basis()
    hi = jax.lax.Precision.HIGHEST
    out = []
    for ci, ((h, v), (rows, cols)) in enumerate(
            zip(geom.sampling, geometry_plane_shapes(geom))):
        p = _downsample(comps[ci], geom.v_max // v, geom.h_max // h)
        blk = _pad_edge(p, rows, cols).reshape(rows // 8, 8, cols // 8, 8)
        t = jnp.einsum("aybx,uy->aubx", blk, a, precision=hi)
        f = jnp.einsum("aubx,vx->aubv", t, a, precision=hi)
        qz = jnp.round(f * inv_q[ci][:, None, :])
        out.append(jnp.clip(qz, -32767.0, 32767.0).astype(jnp.int16)
                   .reshape(rows, cols))
    return out


@lru_cache(maxsize=64)
def forward_planes_fn(geom, batched: bool = False):
    """Jitted :func:`forward_planes`: ``fn(rgb_planar, inv_q)``."""
    def fn(rgb_planar, inv_q):
        return forward_planes(rgb_planar, inv_q, geom)

    return jax.jit(jax.vmap(fn) if batched else fn)
