"""Platform plumbing: mesh activation on multi-GPU hosts, the compile-cache
location, the device per-slot min against the oracle, and chip_smoke.py's
refusal to run without a GPU."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import niqki_tpu
from niqki_tpu import SketchIndex, SketchParams, oracle

REPO = pathlib.Path(__file__).resolve().parent.parent


class _FakeDevice:
    def __init__(self, platform):
        self.platform = platform


def _fake_active_mesh(monkeypatch, devices):
    from niqki_tpu.parallel import auto
    monkeypatch.setattr(auto, "_cache", {})
    monkeypatch.setattr(auto.jax, "devices", lambda: devices)
    monkeypatch.setattr(auto.jax, "device_count", lambda: len(devices))
    monkeypatch.setattr(auto, "make_mesh",
                        lambda devs, dp, tp: ("mesh", len(devs), dp, tp))
    monkeypatch.setenv("NIQKI_TPU_MESH", "auto")
    return auto.active_mesh()


def test_active_mesh_on_four_gpus(monkeypatch):
    """auto meshes a host's four GPUs with the default (dp, tp) shape."""
    got = _fake_active_mesh(monkeypatch, [_FakeDevice("gpu")] * 4)
    assert got == ("mesh", 4, 2, 2)


def test_active_mesh_off_on_cpu_and_single_gpu(monkeypatch):
    assert _fake_active_mesh(monkeypatch, [_FakeDevice("cpu")] * 8) is None
    assert _fake_active_mesh(monkeypatch, [_FakeDevice("gpu")]) is None


def test_compile_cache_dir_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert niqki_tpu.compile_cache_dir() == str(tmp_path / "cc")


def test_compile_cache_dir_default_in_checkout(monkeypatch):
    """Without the env var the cache is a fixed, git-ignored directory
    inside the checkout — never a temp name, pid or time."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = niqki_tpu.compile_cache_dir()
    assert path == str(REPO / ".jax_cache")
    assert niqki_tpu.compile_cache_dir() == path
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def _fasta(tmp_path, seed, n=20000):
    rng = np.random.default_rng(seed)
    seq = bytes(rng.choice(list(b"ACGTacgtN"), n,
                           p=[.23] * 4 + [.015] * 4 + [.02]))
    path = tmp_path / f"g{seed}.fa"
    path.write_bytes(b">a\n" + seq[:n // 2] + b"\n>b\n" + seq[n // 2:] + b"\n")
    return str(path), [seq[:n // 2], seq[n // 2:]]


@pytest.mark.parametrize("params", [
    SketchParams(lF=10),
    SketchParams(lF=15),
    SketchParams(lF=15, W=16).with_best_H(1e6),   # -G, lF + fp bits > 30
], ids=["lF10", "lF15", "G-wide"])
def test_device_slot_min_matches_oracle(params, tmp_path, monkeypatch):
    """The single device per-slot min (scatter-min) through the batched
    whole-file route equals the oracle sketch, multi-record min-merge and
    densify included."""
    monkeypatch.setenv("NIQKI_TPU_SKETCH", "device")
    path, recs = _fasta(tmp_path, params.lF + params.W)
    got = SketchIndex(params).sketch_files([path])[0]
    np.testing.assert_array_equal(got, oracle.sketch_records(recs, params))


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py exits non-zero at its device phase on a CPU backend
    and prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "device" in proc.stdout + proc.stderr
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            assert not json.loads(line).get("ok")
