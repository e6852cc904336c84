"""jpeg_tpu quickstart — run from the repo root with:
    PYTHONPATH=. python examples/quickstart.py [image.jpg]

Covers the main API surface: decode (compat/fast/fancy/YCbCr), encode
(baseline/optimized/progressive), batch decode, and metadata.
"""

import sys

import numpy as np

import jpeg_tpu
from jpeg_tpu.io.container import parse_jpeg
from jpeg_tpu.io.corpus import synthetic_image
from jpeg_tpu.io.ppm import write_ppm
from jpeg_tpu.models.decoder import decode_plan
from jpeg_tpu.parallel.pipeline import BatchedCorpusDecoder

if len(sys.argv) > 1:
    path = sys.argv[1]
    data = open(path, "rb").read()
else:  # a seeded 4:2:0 stream from the repo's own encoder
    path = "<synthetic 320x240>"
    data = jpeg_tpu.encode_rgb(synthetic_image(320, 240, seed=1), quality=90)

# --- decode ---
rgb = jpeg_tpu.decode_bytes(data)                      # bit-exact compat path
fast = jpeg_tpu.decode_bytes(data, path="fast")        # plane path
plan = parse_jpeg(data)
fancy = np.asarray(decode_plan(plan, rounding="round", upsample="fancy"))
ycc = np.asarray(decode_plan(plan, color_space="ycbcr"))
print(f"decoded {path}: {rgb.shape}, fast-vs-compat maxdiff "
      f"{np.abs(rgb.astype(int) - fast.astype(int)).max()}")
write_ppm("quickstart.ppm", rgb)

# --- metadata ---
print("components:", [(c.component_id, c.h, c.v) for c in plan.components],
      "progressive:", plan.progressive, "comment:", plan.comment)

# --- encode ---
img = synthetic_image(320, 240, seed=0)
baseline = jpeg_tpu.encode_rgb(img, quality=88, restart_interval_mcus=4)
optimized = jpeg_tpu.encode_rgb(img, quality=88, optimize=True)
progressive = jpeg_tpu.encode_rgb_progressive(img, quality=88)
print(f"encode 320x240: baseline {len(baseline)}B, optimized "
      f"{len(optimized)}B, progressive {len(progressive)}B")

# --- CMYK (Adobe APP14) ---
from PIL import Image
cmyk = np.asarray(Image.fromarray(img).convert("CMYK"))
adobe = jpeg_tpu.encode_cmyk(cmyk, quality=88)
rgb_from_cmyk = jpeg_tpu.decode_bytes(adobe)
print(f"CMYK encode {len(adobe)}B -> decode {rgb_from_cmyk.shape}, "
      f"model {parse_jpeg(adobe).color_model}")

# --- batch decode (geometry-bucketed plane path) ---
results = BatchedCorpusDecoder(workers=2).decode_all(
    [baseline, optimized, progressive])
print("batch decode ok:", all(r.ok for r in results),
      "identical pixels:", all(
          np.array_equal(results[0].rgb, r.rgb) for r in results[1:]))
