"""jpeg_tpu — a baseline-JPEG engine (JAX/XLA + C++).

A from-scratch re-design of the capabilities of the reference Rust decoder
(martinhath/jpeg-rust) for an NVIDIA GPU:

- Host container layer: marker/JFIF parse -> ``DecodePlan`` tensors
  (parity: reference ``src/jpeg/mod.rs:202-465``).
- Entropy layer: canonical Huffman tables + flat 16-bit LUTs; three decoders
  (NumPy oracle, threaded C++ runtime, lane-parallel device decoder)
  (parity: reference ``src/jpeg/huffman.rs``).
- Device pipeline: dequant+unzigzag+IDCT fused into ONE [64,64] matmul on the
  device, plane assembly by reshape/transpose, chroma upsample, YCbCr->RGB
  (parity: reference ``src/jpeg/decoder.rs`` + ``src/transform.rs``).
- Parallel layer: jax.sharding Mesh + shard_map batch/segment parallelism.

The reference is single-threaded scalar Rust; nothing here is a port. See
SURVEY.md for the blueprint and the file:line parity map.
"""

__version__ = "0.1.0"

from jpeg_tpu.io.container import DecodePlan, parse_jpeg  # noqa: F401
from jpeg_tpu.models.decoder import decode_file, decode_bytes  # noqa: F401
from jpeg_tpu.models.encoder import (  # noqa: F401
    encode_cmyk,
    encode_rgb,
    encode_rgb_device,
    encode_rgb_progressive,
)
