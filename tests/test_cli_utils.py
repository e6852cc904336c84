"""CLI, manifest, corpus, and profiling utility tests."""

import json
import os

import numpy as np
import pytest

from jpeg_tpu.cli import main as cli_main
from jpeg_tpu.io.corpus import generate_corpus, list_corpus, shard_items
from jpeg_tpu.io.ppm import read_ppm
from jpeg_tpu.utils.manifest import Manifest
from jpeg_tpu.utils.profiling import StageTimer


def _seeded_file(tmp_path, width, height, subsampling, name="in.jpg"):
    """A seeded JPEG (repo encoder, no restart markers) written to disk."""
    from jpeg_tpu.io.corpus import synthetic_image
    from jpeg_tpu.models.encoder import encode_rgb

    path = tmp_path / name
    path.write_bytes(encode_rgb(synthetic_image(width, height, seed=7),
                                quality=90, subsampling=subsampling))
    return str(path)


def test_cli_decode_p3(tmp_path, capsys):
    out = tmp_path / "out.ppm"
    src = _seeded_file(tmp_path, 16, 8, (1, 1))
    rc = cli_main(["decode", src, str(out), "--p3"])
    assert rc == 0
    img = read_ppm(out)
    assert img.shape == (8, 16, 3)
    # Reference-identical header (src/main.rs:35).
    assert out.read_bytes().startswith(b"P3\n16 8\n255\n")


def test_cli_encode_decode_roundtrip(tmp_path):
    from PIL import Image

    src = tmp_path / "src.png"
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
    Image.fromarray(img).save(src)
    jpg = tmp_path / "a.jpg"
    ppm = tmp_path / "a.ppm"
    assert cli_main(["encode", str(src), str(jpg), "--quality", "95",
                     "--subsampling", "444", "--restart-interval", "2"]) == 0
    assert cli_main(["decode", str(jpg), str(ppm)]) == 0
    dec = read_ppm(ppm)
    assert dec.shape == img.shape


def test_cli_corpus_with_manifest_resume(tmp_path, capsys):
    corpus_dir = tmp_path / "corpus"
    generate_corpus(str(corpus_dir), 4, width=64, height=48)
    manifest = str(tmp_path / "manifest")
    rc = cli_main(["corpus", str(corpus_dir), "--manifest", manifest])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["decoded"] == 4 and rep["failed"] == 0
    # Resume: nothing left to do.
    rc = cli_main(["corpus", str(corpus_dir), "--manifest", manifest])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["decoded"] == 0


def test_cli_corpus_error_isolation(tmp_path, capsys):
    corpus_dir = tmp_path / "corpus"
    generate_corpus(str(corpus_dir), 2, width=64, height=48)
    (corpus_dir / "broken.jpg").write_bytes(b"\xff\xd8garbage")
    rc = cli_main(["corpus", str(corpus_dir)])
    assert rc == 0  # non-strict: batch survives the bad image
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["decoded"] == 2 and rep["failed"] == 1


def test_cli_diff(tmp_path, capsys):
    rc = cli_main(["diff", _seeded_file(tmp_path, 96, 64, (1, 1))])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out.strip())
    assert rep["psnr_vs_libjpeg_db"] > 40


def test_manifest_crash_safety(tmp_path):
    path = str(tmp_path / "m")
    m = Manifest(path)
    m.mark_done("a", n=1)
    m.mark_done("b")
    m.close()
    # Simulate a torn write from a crash.
    with open(path + ".0.jsonl", "a") as f:
        f.write('{"item": "c", "trunc')
    m2 = Manifest(path)
    assert m2.is_done("a") and m2.is_done("b") and not m2.is_done("c")
    assert m2.pending(["a", "b", "c"]) == ["c"]
    m2.close()


def test_shard_items_partition():
    items = list(range(10))
    shards = [shard_items(items, i, 3) for i in range(3)]
    assert sorted(sum(shards, [])) == items
    assert all(abs(len(s) - 10 / 3) < 1.5 for s in shards)


def test_stage_timer_rates():
    t = StageTimer()
    with t.stage("x", bytes=1000, frames=2):
        pass
    rep = t.report()
    assert rep["x"]["calls"] == 1
    assert "GB_per_s" in rep["x"] and "frames_per_s" in rep["x"]
    json.loads(t.dump())


def test_cli_corpus_batched(tmp_path, capsys):
    corpus_dir = tmp_path / "corpus"
    generate_corpus(str(corpus_dir), 3, width=96, height=64)
    rc = cli_main(["corpus", str(corpus_dir), "--batched"])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["decoded"] == 3 and rep["failed"] == 0


def test_device_trace_noop_and_active(tmp_path):
    from jpeg_tpu.utils.profiling import device_trace

    with device_trace(None):
        pass
    with device_trace(str(tmp_path / "trace")):
        import jax.numpy as jnp

        _ = jnp.zeros((4,)) + 1


def test_cli_info(tmp_path, capsys):
    rc = cli_main(["info", _seeded_file(tmp_path, 750, 595, (2, 2))])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out.strip())
    assert rep["width"] == 750 and rep["height"] == 595
    assert rep["components"][0]["sampling"] == [2, 2]
    assert rep["entropy_segments"] == 1
    assert rep["color_model"] == "ycbcr" and rep["progressive"] is False


def test_cli_encode_cmyk_color(tmp_path, capsys):
    import numpy as np
    from PIL import Image

    from jpeg_tpu.io.corpus import synthetic_image

    src = tmp_path / "in.png"
    Image.fromarray(synthetic_image(64, 48, seed=2)).save(src)
    for color in ("cmyk", "ycck"):
        out = tmp_path / f"{color}.jpg"
        assert cli_main(["encode", str(src), str(out),
                         "--quality", "88", "--color", color]) == 0
        capsys.readouterr()
        assert cli_main(["info", str(out)]) == 0
        rep = json.loads(capsys.readouterr().out.strip())
        assert rep["color_model"] == color and len(rep["components"]) == 4


def test_cli_diff_amplified_output_saturates(tmp_path):
    # Amplified diff must clip at 255, not wrap modulo 256 (a diff of 20
    # at --amplify 16 used to render as 64).
    from PIL import Image

    out = tmp_path / "diff.png"
    src = _seeded_file(tmp_path, 96, 64, (2, 2))
    rc = cli_main(["diff", src, "--amplify", "64",
                   "--diff-output", str(out)])
    assert rc == 0
    diff_img = np.asarray(Image.open(out)).astype(int)
    import jpeg_tpu

    with open(src, "rb") as f:
        ours = np.asarray(jpeg_tpu.decode_bytes(f.read(), rounding="round"))
    pil = np.asarray(Image.open(src).convert("RGB"))
    expect = np.clip(np.abs(ours.astype(int) - pil.astype(int)) * 64, 0, 255)
    np.testing.assert_array_equal(diff_img, expect)


def test_corpus_limit_process_recycling(tmp_path, capsys):
    """--limit N decodes at most N pending images then exits 0;
    rerunning with the same manifest continues (process recycling)."""
    import json

    from jpeg_tpu.cli import main
    from jpeg_tpu.io.corpus import synthetic_image
    from jpeg_tpu.models.encoder import encode_rgb

    for i in range(5):
        (tmp_path / f"{i}.jpg").write_bytes(
            encode_rgb(synthetic_image(96, 64, seed=i), quality=85,
                       subsampling=(2, 2), restart_interval_mcus=3))
    m = str(tmp_path / "m")
    counts = []
    for _ in range(3):
        assert main(["corpus", str(tmp_path), "--batched",
                     "--manifest", m, "--limit", "2"]) == 0
        counts.append(json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])["decoded"])
    assert counts == [2, 2, 1]
    # fully done: another bounded run decodes nothing
    assert main(["corpus", str(tmp_path), "--batched",
                 "--manifest", m, "--limit", "2"]) == 0
