"""Multi-host coordination test: 2 real processes via jax.distributed.

BASELINE configs 4-5 analogue runnable without a pod: two CPU-backend
processes form a distributed JAX runtime over localhost, each decodes its
host shard of a corpus, and metrics aggregate across processes
(jpeg_tpu.parallel.distributed). This exercises the exact
``initialize``/``aggregate_metrics``/``shard_items`` code paths a multi-host
run would use.
"""

import json
import os
import socket
import subprocess
import sys

WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["JPEG_TPU_ROOT"])
import jax
jax.config.update("jax_platforms", "cpu")

from jpeg_tpu.parallel.distributed import aggregate_metrics, initialize
from jpeg_tpu.io.corpus import shard_items, synthetic_jpeg
from jpeg_tpu.models.decoder import decode_bytes

idx, count = initialize(
    coordinator_address=os.environ["COORD"],
    num_processes=2,
    process_id=int(sys.argv[1]),
)
assert count == 2, count

items = [("img%d" % i, 48 + 16 * i) for i in range(5)]
mine = shard_items(items, idx, count)
frames = 0
for name, size in mine:
    rgb = decode_bytes(synthetic_jpeg(size, 48, seed=hash(name) % 100))
    assert rgb.shape == (48, size, 3)
    frames += 1
total = aggregate_metrics({"frames": float(frames)})
print(json.dumps({"idx": idx, "local": frames, "total": total["frames"]}))
"""


def test_two_process_distributed(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["COORD"] = f"127.0.0.1:{port}"
    env["JPEG_TPU_ROOT"] = os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # no virtual devices in the workers
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=150)
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert {o["idx"] for o in outs} == {0, 1}
    assert sum(o["local"] for o in outs) == 5
    # Every process saw the globally aggregated count.
    assert all(o["total"] == 5.0 for o in outs)


CLI_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["JPEG_TPU_ROOT"])
import jax
jax.config.update("jax_platforms", "cpu")
os.environ["JAX_COORDINATOR_ADDRESS"] = os.environ["COORD"]
os.environ["JAX_NUM_PROCESSES"] = "2"
os.environ["JAX_PROCESS_ID"] = sys.argv[1]
from jpeg_tpu.cli import main
sys.exit(main(["corpus", sys.argv[2], "--distributed"]))
"""


def test_two_process_distributed_corpus_cli(tmp_path, capfd):
    """End-to-end multi-host corpus run through the production CLI
    (VERDICT r1 missing #3): cmd_corpus --distributed initializes
    jax.distributed, shards by process, and aggregates frames across
    hosts."""
    from jpeg_tpu.io.corpus import synthetic_jpeg

    corpus_dir = tmp_path / "corpus"
    corpus_dir.mkdir()
    n_images = 5
    for i in range(n_images):
        (corpus_dir / f"img{i}.jpg").write_bytes(
            synthetic_jpeg(48 + 16 * i, 48, seed=i))

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["COORD"] = f"127.0.0.1:{port}"
    env["JPEG_TPU_ROOT"] = os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    script = tmp_path / "cli_worker.py"
    script.write_text(CLI_WORKER)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), str(corpus_dir)],
            env=env, stdout=subprocess.PIPE, text=True)
        for i in range(2)
    ]
    outs = [p.communicate(timeout=180)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    reports = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    locals_ = sorted(r["decoded"] for r in reports)
    assert sum(locals_) == n_images
    assert locals_ == [2, 3]
    for r in reports:
        assert r["process_count"] == 2
        assert r["aggregate"]["decoded"] == float(n_images)
        assert r["aggregate"]["frames_per_s"] > 0
