"""Test config: CPU backend with an 8-device virtual mesh.

Multi-device sharding code paths (jpeg_tpu.parallel) are exercised on
emulated devices per SURVEY.md §4. Tests marked ``gpu`` need an NVIDIA GPU
and skip here; on a machine with one, run them with
``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu``.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from jpeg_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

REFERENCE = "/root/reference"
CORPUS = {
    "huff_simple0": f"{REFERENCE}/working-jpegs/huff_simple0.jpg",
    "lena-bw": f"{REFERENCE}/working-jpegs/lena-bw.jpeg",
    "lena": f"{REFERENCE}/lena.jpeg",
    "2x2-chroma": f"{REFERENCE}/2x2-chroma.jpeg",
}
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")

# Seeded streams from the repo's own encoder: name -> (width, height,
# subsampling (None = grayscale), restart interval in MCUs (0 = none)).
# Odd sizes leave partial MCUs at the right and bottom edges.
STREAMS = {
    "gray": (75, 61, None, 3),
    "gray-nort": (75, 61, None, 0),
    "420": (101, 77, (2, 2), 2),
    "420-nort": (101, 77, (2, 2), 0),
    "422": (90, 52, (2, 1), 3),
    "422-nort": (90, 52, (2, 1), 0),
    "444": (64, 40, (1, 1), 4),
    "444-nort": (64, 40, (1, 1), 0),
}


def make_stream(name: str, seed: int = 0, quality: int = 85) -> bytes:
    from jpeg_tpu.io.corpus import synthetic_image
    from jpeg_tpu.models.encoder import encode_rgb

    w, h, sub, ri = STREAMS[name]
    img = synthetic_image(w, h, seed)
    if sub is None:
        return encode_rgb(img[..., 0], quality=quality,
                          restart_interval_mcus=ri)
    return encode_rgb(img, quality=quality, subsampling=sub,
                      restart_interval_mcus=ri)


@pytest.fixture(scope="session")
def stream_corpus():
    """Seeded JPEG streams: gray, 4:2:0, 4:2:2, 4:4:4, each with and
    without restart markers (see ``STREAMS``)."""
    return {name: make_stream(name, seed=i)
            for i, name in enumerate(STREAMS)}


@pytest.fixture(scope="session")
def corpus():
    """The reference JPEGs; golden and fidelity tests compare against
    their own bytes."""
    missing = [p for p in CORPUS.values() if not os.path.exists(p)]
    if missing:
        pytest.skip(f"reference corpus absent ({missing[0]})")
    return {k: open(v, "rb").read() for k, v in CORPUS.items()}


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is an NVIDIA GPU."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda,cpu ... -m gpu)")
    return jax.devices()[0]


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean()
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0**2 / mse)
