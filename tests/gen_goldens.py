"""Generate golden decode outputs for the reference corpus.

Run once (CPU backend) and commit the result:
    python tests/gen_goldens.py

Goldens are this engine's reference-compat (truncating) decode, cross-checked
at generation time against PIL/libjpeg with a PSNR gate — the Rust reference
binary cannot run here (no rustc in image), so libjpeg is the independent
oracle per SURVEY.md §6, with the expected deviations: truncation vs rounding
and replication vs fancy upsampling.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# Goldens come from the deterministic CPU backend.
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
from PIL import Image

from conftest import CORPUS, GOLDEN_DIR, psnr
from jpeg_tpu.models.decoder import decode_file

MIN_PSNR = {"huff_simple0": 50.0, "lena-bw": 50.0, "lena": 40.0, "2x2-chroma": 40.0}


def main():
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name, path in CORPUS.items():
        ours = decode_file(path, rounding="truncate", engine="oracle")
        pil = np.asarray(Image.open(path).convert("RGB"))
        p = psnr(ours, pil)
        assert p >= MIN_PSNR[name], f"{name}: PSNR {p:.1f} < {MIN_PSNR[name]}"
        np.savez_compressed(os.path.join(GOLDEN_DIR, f"{name}.npz"), rgb=ours)
        print(f"{name}: {ours.shape} PSNR_vs_libjpeg={p:.1f}dB -> goldens/{name}.npz")


if __name__ == "__main__":
    main()
