"""DCT math as linear algebra.

Parity: reference ``src/transform.rs`` (naive O(d^4) scalar loops). Here the
8x8 IDCT is expressed as linear algebra so it runs as matrix products:

    spatial = A^T F A          (A = 1-D DCT-II basis, 8x8)
    flat:   out = f @ kron(A, A)

and — the core trick of this engine — dequantization (a diagonal matrix in
zigzag order), the inverse-zigzag permutation, and the IDCT all *fold into a
single precomputed [64, 64] matrix* per quant table:

    pixels[N, 64] = coeffs_zigzag[N, 64] @ (diag(q_zz) @ P @ kron(A, A))

One big matmul per component: no gathers, no per-block loops.
The matrices are built once in float64 on host and cast down.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from jpeg_tpu.ops.zigzag import permutation_matrix


def dct_basis_1d() -> np.ndarray:
    """A[u, x] = alpha(u)/2 * cos((2x+1) u pi / 16), float64 [8, 8].

    Same basis the reference evaluates pointwise per output pixel
    (``src/transform.rs:66-84``).
    """
    u = np.arange(8, dtype=np.float64)[:, None]
    x = np.arange(8, dtype=np.float64)[None, :]
    a = np.cos((2.0 * x + 1.0) * u * np.pi / 16.0)
    alpha = np.ones(8, dtype=np.float64)
    alpha[0] = 1.0 / np.sqrt(2.0)
    return (alpha[:, None] / 2.0) * a


@lru_cache(maxsize=None)
def _idct_kron() -> np.ndarray:
    """kron(A, A): [64, 64] so that out_flat = F_flat(natural) @ K."""
    a = dct_basis_1d()
    return np.kron(a, a)


def fused_idct_matrix(quant_zz: np.ndarray, dtype=np.float32) -> np.ndarray:
    """[64, 64] matrix fusing dequant + unzigzag + IDCT for one quant table.

    ``quant_zz`` is the table in zigzag order (as stored in DQT; parity with
    the reference's elementwise dequant at ``src/jpeg/decoder.rs:230-233``).
    """
    q = np.asarray(quant_zz, dtype=np.float64).reshape(64)
    m = (q[:, None] * permutation_matrix().astype(np.float64)) @ _idct_kron()
    return m.astype(dtype)


def idct_block_naive(block_nat: np.ndarray) -> np.ndarray:
    """Direct-formula scalar IDCT of one natural-order [64] block (float32).

    Test-only parity twin of reference
    ``discrete_cosine_transform_inverse`` (``src/transform.rs:55-87``).
    """
    f = np.asarray(block_nat, dtype=np.float32).reshape(8, 8)
    out = np.zeros((8, 8), dtype=np.float32)
    alpha = np.ones(8, dtype=np.float32)
    alpha[0] = np.float32(1.0 / np.sqrt(2.0))
    for y in range(8):
        for x in range(8):
            s = np.float32(0.0)
            for v in range(8):
                for u in range(8):
                    s += (
                        alpha[u]
                        * alpha[v]
                        * f[v, u]
                        * np.float32(np.cos((2 * x + 1) * u * np.pi / 16))
                        * np.float32(np.cos((2 * y + 1) * v * np.pi / 16))
                    )
            out[y, x] = s / 4
    return out.reshape(64)


def dct_block_naive(pixels_nat: np.ndarray) -> np.ndarray:
    """Forward DCT of one [64] block — parity twin of the reference's unused
    forward transform (``src/transform.rs:18-53``), used by the encoder tests."""
    g = np.asarray(pixels_nat, dtype=np.float32).reshape(8, 8)
    out = np.zeros((8, 8), dtype=np.float32)
    alpha = np.ones(8, dtype=np.float32)
    alpha[0] = np.float32(1.0 / np.sqrt(2.0))
    for v in range(8):
        for u in range(8):
            s = np.float32(0.0)
            for y in range(8):
                for x in range(8):
                    s += (
                        g[y, x]
                        * np.float32(np.cos((2 * x + 1) * u * np.pi / 16))
                        * np.float32(np.cos((2 * y + 1) * v * np.pi / 16))
                    )
            out[v, u] = alpha[u] * alpha[v] * s / 4
    return out.reshape(64)


def forward_dct_matrix(dtype=np.float32) -> np.ndarray:
    """[64, 64] matrix: flat pixels (natural order) -> DCT coefficients
    (natural order): coeffs = pixels @ kron(A, A).T (used by the encoder)."""
    return _idct_kron().T.astype(dtype)
