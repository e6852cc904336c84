"""The flagship model: end-to-end baseline-JPEG decode pipeline.

Replaces reference ``JPEGDecoder::decode`` (``src/jpeg/decoder.rs:162-343``)
with a two-stage design (SURVEY.md §7):

1. **Entropy stage** (host C++/NumPy): bitstream ->
   ``[total_blocks, 64]`` int32 coefficient tensor, zigzag order, DC
   prediction applied, MCU stream order.
2. **Dense device stage** (one jitted function): per component, a single
   ``[N, 64] @ [64, 64]`` matmul performs dequant + unzigzag + IDCT
   (see :mod:`jpeg_tpu.ops.idct`), then reshape/transpose assembly, chroma
   upsample, and YCbCr->RGB — all fused by XLA.

The jit cache is keyed on *geometry* only (shapes, sampling factors); the
fused quant matrices are runtime arguments, so decoding a corpus of
same-sized images compiles exactly once.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from jpeg_tpu.io.container import DecodePlan, parse_jpeg
from jpeg_tpu.ops.color import grayscale_to_rgb, ycbcr_to_rgb
from jpeg_tpu.ops.idct import fused_idct_matrix
from jpeg_tpu.ops.upsample import component_plane


@dataclasses.dataclass(frozen=True)
class PipelineGeometry:
    """Static shape info for one image class — the jit cache key."""

    width: int
    height: int
    mcus_x: int
    mcus_y: int
    h_max: int
    v_max: int
    sampling: tuple[tuple[int, int], ...]  # (h, v) per component, scan order
    # Final color stage: gray | ycbcr | rgb | cmyk | ycck (plan.color_model).
    color_model: str = "ycbcr"
    precision: int = 8  # sample precision (12-bit => u16 output)

    @staticmethod
    def of(plan: DecodePlan) -> "PipelineGeometry":
        return PipelineGeometry(
            width=plan.width,
            height=plan.height,
            mcus_x=plan.mcus_x,
            mcus_y=plan.mcus_y,
            h_max=plan.h_max,
            v_max=plan.v_max,
            sampling=tuple((c.h, c.v) for c in plan.components),
            color_model=getattr(plan, "color_model", "ycbcr"),
            precision=getattr(plan, "precision", 8),
        )

    @property
    def blocks_per_mcu(self) -> int:
        return sum(h * v for h, v in self.sampling)

    @property
    def n_mcus(self) -> int:
        return self.mcus_x * self.mcus_y

    @property
    def total_blocks(self) -> int:
        return self.n_mcus * self.blocks_per_mcu

    def component_slot_ranges(self) -> list[tuple[int, int]]:
        """Per component: (offset, count) of its block slots within one MCU.

        The MCU-interleaved stream (JPEG A.2.3) keeps each component's v*h
        blocks contiguous inside the MCU, so de-interleaving is a reshape to
        [n_mcu, blocks_per_mcu, 64] plus a static slice — no gather. Replaces
        the reference's interleave bookkeeping
        (``src/jpeg/decoder.rs:195-215``)."""
        out = []
        offset = 0
        for h, v in self.sampling:
            out.append((offset, h * v))
            offset += h * v
        return out

    def component_gather_indices(self) -> list[np.ndarray]:
        """Flat stream-row indices per component (used by host-side code and
        tests; the device pipeline uses :meth:`component_slot_ranges`)."""
        bpm = self.blocks_per_mcu
        base = np.arange(self.n_mcus, dtype=np.int32)[:, None] * bpm
        return [
            (base + np.arange(off, off + k, dtype=np.int32)[None, :]).reshape(-1)
            for off, k in self.component_slot_ranges()
        ]


def _pipeline(coeffs, matrices, geom: PipelineGeometry, rounding: str,
              gather_idx: tuple = (), upsample: str = "replicate",
              color_space: str = "rgb"):
    """coeffs [total_blocks, 64] i32/f32, matrices [ncomp, 64, 64] f32
    -> [H, W, 3] u8 (RGB, or full-resolution YCbCr planes when
    ``color_space="ycbcr"`` — the layout ML input pipelines typically want).
    Pure function of tensors; jitted via _compiled()."""
    del gather_idx  # de-interleave is a reshape+slice, no gather needed
    planes = []
    coeffs = coeffs.astype(jnp.float32)
    mcu_view = coeffs.reshape(geom.n_mcus, geom.blocks_per_mcu, 64)
    for ci, ((h, v), (off, k)) in enumerate(
        zip(geom.sampling, geom.component_slot_ranges())
    ):
        comp_coeffs = mcu_view[:, off : off + k].reshape(-1, 64)  # [n_mcu*h*v, 64]
        # Fused dequant+unzigzag+IDCT: one matmul (f32, full precision
        # for bit-exactness vs the scalar oracle).
        pixels = jax.lax.dot(
            comp_coeffs,
            matrices[ci],
            precision=jax.lax.Precision.HIGHEST,
        )  # [n, 64]
        plane = component_plane(
            pixels.reshape(-1, 8, 8), geom.mcus_y, geom.mcus_x, v, h,
            geom.v_max, geom.h_max, geom.height, geom.width,
            upsample=upsample,
        )
        planes.append(plane)
    maxval = (1 << geom.precision) - 1
    shift = float((maxval + 1) // 2)
    if color_space == "ycbcr":
        from jpeg_tpu.ops.color import quantize_samples

        chans = [quantize_samples(p + shift, rounding, maxval)
                 for p in planes]
        while len(chans) < 3:
            chans.append(jnp.full_like(chans[0], (maxval + 1) // 2))
        return jnp.stack(chans, axis=-1)
    if len(planes) == 1:
        return grayscale_to_rgb(planes[0], rounding, maxval)
    if len(planes) == 3:
        if geom.color_model == "rgb":  # Adobe transform 0 / R,G,B ids
            from jpeg_tpu.ops.color import rgb_direct

            return rgb_direct(planes[0], planes[1], planes[2], rounding,
                              maxval)
        return ycbcr_to_rgb(planes[0], planes[1], planes[2], rounding,
                            maxval)
    if len(planes) == 4:  # Adobe CMYK / YCCK (beyond the reference)
        from jpeg_tpu.ops.color import cmyk_to_rgb

        return cmyk_to_rgb(planes[0], planes[1], planes[2], planes[3],
                           rounding, ycck=geom.color_model == "ycck")
    raise ValueError(f"unsupported component count {len(planes)} "
                     "(reference supports 1 or 3, src/jpeg/decoder.rs:317-331)")


@lru_cache(maxsize=256)
def _compiled(geom: PipelineGeometry, rounding: str,
              upsample: str = "replicate", color_space: str = "rgb"):
    return jax.jit(partial(_pipeline, geom=geom, rounding=rounding,
                           upsample=upsample, color_space=color_space))


def plan_matrices(plan: DecodePlan) -> np.ndarray:
    """[ncomp, 64, 64] f32 fused dequant+unzigzag+IDCT matrices."""
    return np.stack(
        [fused_idct_matrix(plan.quant_tables[c.quant_id]) for c in plan.components]
    )


def decode_coefficients_host(plan: DecodePlan, engine: str = "auto") -> np.ndarray:
    """Entropy-decode on host -> [total_blocks, 64] i32.

    ``engine``: "native" (threaded C++ runtime), "oracle" (NumPy reference
    semantics), or "auto" (native if built, else oracle).
    """
    if getattr(plan, "arith_code", False):
        # SOF9/SOF10 arithmetic entropy (QM coder) — beyond the reference.
        if plan.progressive:
            if engine in ("auto", "native"):
                try:
                    from jpeg_tpu.runtime import native_decode_progressive

                    return native_decode_progressive(plan)
                except (ImportError, OSError):
                    if engine == "native":
                        raise
            from jpeg_tpu.entropy.arith import (
                decode_progressive_coefficients_arith,
            )

            return decode_progressive_coefficients_arith(plan)
        if engine in ("auto", "native"):
            try:
                from jpeg_tpu.runtime import native_decode_arith_coefficients

                return native_decode_arith_coefficients(plan)
            except (ImportError, OSError):
                if engine == "native":
                    raise
        from jpeg_tpu.entropy.arith import decode_coefficients_arith

        return decode_coefficients_arith(plan)
    if plan.progressive:
        if engine in ("auto", "native"):
            try:
                from jpeg_tpu.runtime import native_decode_progressive

                return native_decode_progressive(plan)
            except (ImportError, OSError):
                if engine == "native":
                    raise
        from jpeg_tpu.entropy.progressive import decode_progressive_coefficients

        return decode_progressive_coefficients(plan)
    if engine in ("auto", "native"):
        try:
            from jpeg_tpu.runtime import native_decode_coefficients

            return native_decode_coefficients(plan)
        except (ImportError, OSError):
            if engine == "native":
                raise
    from jpeg_tpu.entropy.oracle import decode_coefficients

    return decode_coefficients(plan)


def decode_plan(plan: DecodePlan, rounding: str = "truncate",
                engine: str = "auto", coefficients: np.ndarray | None = None,
                upsample: str = "replicate", color_space: str = "rgb"):
    """DecodePlan -> RGB [H, W, 3] u8 (jax array).

    ``upsample``: "replicate" (reference parity) or "fancy" (libjpeg-style
    triangular chroma filter — higher PSNR vs libjpeg's own decodes).
    """
    if getattr(plan, "lossless", False):
        # SOF3: no DCT/color pipeline — samples come out as stored
        # (T.81 H; grayscale replicates to 3 channels like the DCT
        # paths, multi-component streams are component-direct). The
        # predictor-1/2 reconstruction runs as device cumsum scans.
        from jpeg_tpu.entropy.lossless import decode_lossless

        samples = decode_lossless(plan, device=True)
        if samples.shape[2] == 1:
            samples = np.repeat(samples, 3, axis=2)
        if plan.precision <= 8:
            samples = samples.astype(np.uint8)
        return jnp.asarray(samples)
    if coefficients is None:
        coefficients = decode_coefficients_host(plan, engine)
    geom = PipelineGeometry.of(plan)
    fn = _compiled(geom, rounding, upsample, color_space)
    return fn(jnp.asarray(coefficients), jnp.asarray(plan_matrices(plan)))


def decode_plan_fast(plan: DecodePlan, rounding: str = "truncate",
                     idct_mode: str = "exact"):
    """The plane path: C++ plane-layout entropy + the plain-JAX pixel stage
    (:mod:`jpeg_tpu.ops.pixel`).

    Within 1 u8 of the compat pipeline, not bit-exact: the separable IDCT
    sums in another order than the fused [64, 64] matmul. Use the default
    compat path when bit-exactness vs the reference semantics matters.

    ``idct_mode="approx"`` runs the IDCT contractions at DEFAULT precision
    (TF32 on a GPU); its measured error is in ``docs/APPROX_QUALITY.md``.
    """
    from jpeg_tpu.ops.pixel import decode_planes, plane_path_supported
    from jpeg_tpu.runtime import native_decode_planes

    if (getattr(plan, "lossless", False)
            or not plane_path_supported(PipelineGeometry.of(plan))):
        # SOF3 has no coefficient planes; RGB-direct, CMYK/YCCK and 12-bit
        # streams take the compat pipeline, which handles every color
        # model and precision.
        return decode_plan(plan, rounding=rounding)
    if plan.progressive:
        planes = progressive_planes(plan)
    elif getattr(plan, "arith_code", False):
        from jpeg_tpu.runtime import native_decode_arith_planes

        planes = native_decode_arith_planes(plan)
    else:
        planes = native_decode_planes(plan)
    return decode_planes(planes, plan, rounding, idct_mode)


def progressive_planes(plan: DecodePlan) -> list[np.ndarray]:
    """Progressive entropy decode -> int16 coefficient planes in the fast
    path's plane layout (``jpeg_tpu.ops.pixel.plane_shapes``).

    When the native path is used, the returned arrays are the runtime's
    per-thread scratch buffers (same ``reuse_buffer`` contract as
    :func:`jpeg_tpu.runtime.native_decode_planes`): consume or ``.copy()``
    them before the calling thread decodes another same-geometry image."""
    from jpeg_tpu.entropy.progressive import decode_progressive_coefficients
    from jpeg_tpu.ops.zigzag import unzigzag
    from jpeg_tpu.runtime import plane_shapes

    try:
        from jpeg_tpu.runtime import native_decode_progressive_planes

        # All-C++ path: scans + de-zigzag plane assembly, no intermediate
        # [total_blocks, 64] stream or numpy grid relayouts (Huffman AND
        # arithmetic scans).
        return native_decode_progressive_planes(plan)
    except (ImportError, OSError):
        if getattr(plan, "arith_code", False):
            from jpeg_tpu.entropy.arith import (
                decode_progressive_coefficients_arith,
            )

            coeffs = decode_progressive_coefficients_arith(plan)
        else:
            coeffs = decode_progressive_coefficients(plan)
    shapes = plane_shapes(plan)
    planes = [np.zeros(s, np.int16) for s in shapes]
    bpm = plan.blocks_per_mcu
    my, mx = np.divmod(np.arange(plan.n_mcus), plan.mcus_x)
    grids = {}
    for si, (ci, sub) in enumerate(plan.component_block_slots()):
        c = plan.components[ci]
        vi, hi = divmod(sub, c.h)
        if ci not in grids:
            grids[ci] = np.zeros(
                (plan.mcus_y * c.v, plan.mcus_x * c.h, 8, 8), np.int16)
        nat = unzigzag(coeffs[si::bpm]).reshape(-1, 8, 8)
        grids[ci][my * c.v + vi, mx * c.h + hi] = nat
    for ci, grid in grids.items():
        rows, cols = grid.shape[:2]
        planes[ci][: rows * 8, : cols * 8] = grid.transpose(
            0, 2, 1, 3).reshape(rows * 8, cols * 8)
    return planes


def decode_bytes(data: bytes, rounding: str = "truncate",
                 engine: str = "auto", path: str = "compat",
                 upsample: str = "replicate",
                 color_space: str = "rgb",
                 idct_mode: str = "exact") -> np.ndarray:
    """JPEG bytes -> RGB [H, W, 3] u8 numpy array.

    Library-surface parity with reference ``JPEGImage::parse`` +
    ``image_data()`` (``src/jpeg/mod.rs:202,467-477``) — but returns an
    [H, W, 3] tensor rather than a Vec of tuples. ``path="fast"`` selects
    the plane pipeline (see :func:`decode_plan_fast`).
    ``color_space="ycbcr"`` skips the final color convert and returns the
    level-shifted full-resolution planes (3 channels for YCbCr/gray
    streams, 4 for CMYK/YCCK) — the ML input-pipeline layout.
    """
    plan = parse_jpeg(data)
    if path == "fast" and color_space == "rgb":
        return np.asarray(decode_plan_fast(plan, rounding=rounding,
                                           idct_mode=idct_mode))
    return np.asarray(decode_plan(plan, rounding=rounding, engine=engine,
                                  upsample=upsample, color_space=color_space))


def apply_exif_orientation(rgb: np.ndarray, orientation: int | None) -> np.ndarray:
    """Apply an EXIF orientation tag (1-8) to a decoded [H, W, 3] image."""
    if not orientation or orientation == 1:
        return rgb
    ops = {
        2: lambda x: x[:, ::-1],
        3: lambda x: x[::-1, ::-1],
        4: lambda x: x[::-1],
        5: lambda x: x.transpose(1, 0, 2),
        6: lambda x: x.transpose(1, 0, 2)[:, ::-1],
        7: lambda x: x.transpose(1, 0, 2)[::-1, ::-1],
        8: lambda x: x.transpose(1, 0, 2)[::-1],
    }
    fn = ops.get(orientation)
    return np.ascontiguousarray(fn(rgb)) if fn else rgb


def decode_file(path, rounding: str = "truncate", engine: str = "auto",
                exif_orientation: bool = False) -> np.ndarray:
    """Parity with the reference CLI input path (``src/main.rs:16-31``).
    ``exif_orientation=True`` applies the EXIF orientation tag (phones)."""
    with open(path, "rb") as f:
        data = f.read()
    if not exif_orientation:
        return decode_bytes(data, rounding=rounding, engine=engine)
    plan = parse_jpeg(data)
    rgb = np.asarray(decode_plan(plan, rounding=rounding, engine=engine))
    return apply_exif_orientation(
        rgb, (plan.exif or {}).get("orientation"))
