"""The plane pixel stage (jpeg_tpu.ops.pixel), its layout, the build key,
the compile cache, and chip_smoke.py's refusal to run without a GPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

from jpeg_tpu.io.container import parse_jpeg
from jpeg_tpu.io.corpus import synthetic_image
from jpeg_tpu.models.decoder import PipelineGeometry, decode_bytes
from jpeg_tpu.models.encoder import encode_rgb
from jpeg_tpu.ops import pixel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLINGS = {"gray": None, "420": (2, 2), "422": (2, 1), "444": (1, 1)}


def _encode(width, height, sampling, seed=0, restart=2):
    img = synthetic_image(width, height, seed)
    if sampling is None:
        return encode_rgb(img[..., 0], quality=85,
                          restart_interval_mcus=restart), img[..., 0]
    return encode_rgb(img, quality=85, subsampling=sampling,
                      restart_interval_mcus=restart), img


@pytest.mark.parametrize("size", [(37, 29), (64, 48)])
@pytest.mark.parametrize("rounding", ["truncate", "round"])
@pytest.mark.parametrize("name", list(SAMPLINGS))
def test_planes_to_rgb_within_one_of_compat(name, rounding, size):
    """The plane pipeline stays within 1 u8 of the bit-exact compat
    pipeline for every sampling, rounding mode and partial-MCU size."""
    data, _ = _encode(*size, SAMPLINGS[name], seed=sum(size))
    compat = decode_bytes(data, rounding=rounding)
    fast = decode_bytes(data, rounding=rounding, path="fast")
    assert fast.shape == compat.shape == (size[1], size[0], 3)
    assert np.abs(fast.astype(int) - compat.astype(int)).max() <= 1


def test_plane_shapes_cover_whole_mcus():
    assert pixel.plane_shapes(5, 3, [(2, 2), (1, 1), (1, 1)]) == [
        (48, 80), (24, 40), (24, 40)]
    assert pixel.plane_shapes(7, 2, [(1, 1)]) == [(16, 56)]


def test_plane_path_supported_routes():
    geom = PipelineGeometry(width=16, height=16, mcus_x=1, mcus_y=1,
                            h_max=2, v_max=2,
                            sampling=((2, 2), (1, 1), (1, 1)))
    assert pixel.plane_path_supported(geom)
    import dataclasses

    for change in (dict(color_model="cmyk"), dict(color_model="rgb"),
                   dict(precision=12)):
        assert not pixel.plane_path_supported(
            dataclasses.replace(geom, **change)), change


def test_decode_batch_fast_returns_cropped_hwc():
    from jpeg_tpu.parallel.batch import decode_batch_fast
    from jpeg_tpu.runtime import native_decode_planes

    data, _ = _encode(50, 30, (2, 2))
    plan = parse_jpeg(data)
    planes = [p.copy()[None] for p in native_decode_planes(plan)]
    q = pixel.plan_quant_tables(plan)[None]
    out = np.asarray(decode_batch_fast(planes, q, PipelineGeometry.of(plan)))
    assert out.shape == (1, 30, 50, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(out[0], decode_bytes(data, path="fast"))


@pytest.mark.parametrize("name", list(SAMPLINGS))
def test_forward_planes_match_host_encoder(name):
    """The device forward transform's quantized coefficients are within
    one step of the host encoder's, component by component."""
    from jpeg_tpu.models.encoder import _forward_transform
    from jpeg_tpu.ops.zigzag import unzigzag

    sampling = SAMPLINGS[name]
    width, height = 72, 40
    img = synthetic_image(width, height, seed=5)
    if sampling is None:
        img = img[..., 0]
    blocks_zz, samplings, quant_zz, _, _, mcus_x, mcus_y, gray = (
        _forward_transform(img, 85, sampling or (1, 1), sampling is None))
    geom = PipelineGeometry(
        width=width, height=height, mcus_x=mcus_x, mcus_y=mcus_y,
        h_max=max(h for h, _ in samplings), v_max=max(v for _, v in samplings),
        sampling=tuple(samplings))
    planar = img[None] if gray else img.transpose(2, 0, 1)
    comp_q = [quant_zz[min(c, len(quant_zz) - 1)] for c in range(len(samplings))]
    got = pixel.forward_planes_fn(geom)(planar,
                                        pixel.inverse_quant_tables(comp_q))
    for zz, plane in zip(blocks_zz, got):
        r, c, _ = zz.shape
        want = unzigzag(zz.reshape(-1, 64)).reshape(r, c, 8, 8)
        want = want.transpose(0, 2, 1, 3).reshape(r * 8, c * 8)
        assert np.abs(np.asarray(plane).astype(int) - want).max() <= 1


def test_compile_cache_defaults_to_checkout(monkeypatch):
    from jpeg_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, "build", "jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "build/" in f.read().split()


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    import jax

    from jpeg_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_build_key_is_stable_hex():
    from jpeg_tpu import runtime

    key = runtime.build_key()
    assert key == runtime.build_key()
    assert len(key) == 16 and int(key, 16) >= 0
    lib = os.path.join(runtime._BUILD_ROOT, key, "libjpegtpu.so")
    runtime._load()
    assert os.path.exists(lib)


@pytest.mark.parametrize("change", ["cpu", "flags"])
def test_build_key_changes_with_host_and_flags(monkeypatch, change):
    from jpeg_tpu import runtime

    key = runtime.build_key()
    monkeypatch.setattr(runtime, "_build_key", None)
    if change == "cpu":
        monkeypatch.setattr(runtime, "_cpu_model", lambda: "another cpu")
    else:
        monkeypatch.setenv("CXXFLAGS", "-O2")
    assert runtime.build_key() != key


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    done = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0
    assert '"ok": true' not in done.stdout


def test_chip_smoke_alone_fails(tmp_path):
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    done = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0
    assert '"ok": true' not in done.stdout


@pytest.mark.gpu
def test_plane_path_gpu_matches_cpu(gpu):
    """On the card: the plane path within 1 u8 of the CPU backend's."""
    import jax

    data, _ = _encode(1920, 1080, (2, 2))
    on_gpu = decode_bytes(data, path="fast")
    with jax.default_device(jax.devices("cpu")[0]):
        on_cpu = decode_bytes(data, path="fast")
    assert np.abs(on_gpu.astype(int) - on_cpu.astype(int)).max() <= 1
