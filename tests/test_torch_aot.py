"""``metrics_tpu_torch.aot``: the JAX package's AOT-cache names over the port's kernel-library build cache.
The digests and call signatures equal the JAX package's; the manifests round-trip and refuse damage and
another environment; ``warm_registry`` builds once and then nothing; all through the host RLE codec, which
``g++`` builds here (the CUDA libraries need ``nvcc`` and a card)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import metrics_tpu_torch.aot as aot
from metrics_tpu_torch.aot import cache
from metrics_tpu_torch.ops import _native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIB = "rle_codec"


@pytest.fixture
def cache_dir(tmp_path):
    prev = aot.cache_dir()
    aot.set_cache_dir(tmp_path / "kernels")
    yield str(tmp_path / "kernels")
    aot.set_cache_dir(prev if prev != str(_native.DEFAULT_BUILD_DIR) else None)


def test_names_match_the_jax_package_s():
    import metrics_tpu.aot as jaot

    assert aot.__all__ == jaot.__all__[:1] + jaot.__all__[2:]  # AotBinding has no counterpart
    assert aot.active() is False and aot.ENV_VAR == "METRICS_TPU_TORCH_KERNEL_CACHE"


@pytest.mark.parametrize("key", [("kernel-library", "rle_codec", "librle_codec-0123.so"),
                                 ("MeanMetric", "a" * 64, (("mean_value", (), "float32"),), 16, False),
                                 (1, 2.5, None, "x", (True, ()))])
def test_entry_digest_is_the_jax_package_s(key):
    from metrics_tpu.aot.cache import entry_digest

    assert aot.entry_digest(key) == entry_digest(key)


@pytest.mark.parametrize("args,kwargs", [
    ((np.zeros(3, np.float32), np.int32(2), 1.5, None, [1, (2, 3)]), {"b": np.ones((2, 2)), "a": "x"}),
    ((np.zeros((1,), np.int64),), {}),
    ((), {}),
    (((np.float32(1.0),),), {"w": [np.zeros((2, 3), np.bool_), None]}),
])
def test_call_signature_matches_on_numpy_inputs(args, kwargs):
    from metrics_tpu.aot.runtime import call_signature

    assert aot.call_signature(args, kwargs) == call_signature(args, kwargs)


def test_call_signature_of_tensors_uses_numpy_dtype_names():
    import torch

    sig = aot.call_signature((torch.zeros(2, dtype=torch.int32),), {})
    assert sig == aot.call_signature((np.zeros(2, np.int32),), {})


def test_manifest_round_trips_and_refuses_damage(cache_dir):
    """A stored manifest validates and finds its library; truncated, bit-flipped or renamed ones, and a library
    whose bytes changed, raise ``CorruptEntryError`` (the lookup misses and latches until the next store)."""
    _native.build([LIB])
    assert cache.lookup(LIB) == _native.library_path(LIB)  # the build wrote its manifest
    digest = cache.entry_digest(cache._library_key(LIB))
    path = cache.entry_path(digest)
    os.unlink(path)
    assert cache.lookup(LIB) is None  # no manifest
    assert cache.store(LIB)
    assert cache.lookup(LIB) == _native.library_path(LIB)
    header, payload = cache.read_entry(path, digest)
    assert header["env"] == aot.environment_fingerprint() and json.loads(payload)["library"] == _native.library_path(LIB).name
    blob = open(path, "rb").read()
    for damaged in (blob[:-7], blob[:-1] + bytes([blob[-1] ^ 0xFF]), b"XXXXXXXX" + blob[8:]):
        open(path, "wb").write(damaged)
        with pytest.raises(aot.CorruptEntryError):
            cache.read_entry(path, digest)
    with pytest.raises(aot.CorruptEntryError):
        open(path, "wb").write(blob)
        cache.read_entry(path, "0" * 64)
    lib = _native.library_path(LIB)
    original = lib.read_bytes()
    lib.write_bytes(original[:-1] + bytes([original[-1] ^ 0xFF]))
    assert cache.lookup(LIB) is None and cache.lookup(LIB) is None  # latched
    lib.write_bytes(original)
    assert cache.store(LIB) and cache.lookup(LIB) == lib  # the store lifts the latch


@pytest.mark.parametrize("fault", ["bit-flipped library", "corrupt manifest", "another environment"])
def test_the_build_reloads_only_what_its_manifest_validates(cache_dir, monkeypatch, fault):
    """``_native.build`` decides through the manifest: a library whose bytes differ from it, a damaged
    manifest or one from another environment is rebuilt (and manifested anew); a valid one is not."""
    _native.build([LIB])
    assert _native.build_outcomes[LIB] == "built"
    lib = _native.library_path(LIB)
    digest = cache.entry_digest(cache._library_key(LIB))
    if fault == "bit-flipped library":
        original = lib.read_bytes()
        lib.write_bytes(original[:-1] + bytes([original[-1] ^ 0xFF]))
    elif fault == "corrupt manifest":
        blob = open(cache.entry_path(digest), "rb").read()
        open(cache.entry_path(digest), "wb").write(blob[:-1] + bytes([blob[-1] ^ 0xFF]))
    else:
        monkeypatch.setattr(cache, "_ENV_FP", dict(aot.environment_fingerprint(), cxx="g++ 0.0 (another compiler)"))
    _native.build([LIB])
    assert _native.build_outcomes[LIB] == "refreshed"
    header, _ = cache.read_entry(cache.entry_path(digest), digest)
    assert header["env"] == aot.environment_fingerprint() and cache.lookup(LIB) == lib
    _native.build([LIB])
    assert _native.build_outcomes[LIB] == "hit"


def test_another_environment_is_stale(cache_dir, monkeypatch):
    _native.build([LIB])
    assert cache.store(LIB)
    digest = cache.entry_digest(cache._library_key(LIB))
    env = dict(aot.environment_fingerprint(), cxx="g++ 0.0 (another compiler)")
    monkeypatch.setattr(cache, "_ENV_FP", env)
    with pytest.raises(aot.StaleEntryError, match="cxx"):
        cache.read_entry(cache.entry_path(digest), digest)
    assert cache.lookup(LIB) is None


def test_warm_builds_once_then_nothing_and_purge_empties(cache_dir):
    """A cold warm run builds the library and writes its manifest, a second finds it valid and builds
    nothing, a stale manifest rebuilds once; purge removes libraries and manifests."""
    from metrics_tpu_torch.aot.warm import warm_registry

    cold = warm_registry(cache_dir, classes=["BinaryAccuracy"], device="cpu")
    assert cold["libraries"] == {LIB: "built"} and cold["cases"] == {"BinaryAccuracy": {"status": "updated"}}
    assert aot.cache_stats(cache_dir) | {"bytes": 0} == {"directory": cache_dir, "entries": 1, "libraries": 1,
                                                         "bytes": 0}
    warm = warm_registry(cache_dir, classes=[], device="cpu")
    assert warm["libraries"] == {LIB: "hit"} and warm["built"] == 0 and warm["cases"] == {}
    digest = cache.entry_digest(cache._library_key(LIB))
    path = cache.entry_path(digest, cache_dir)
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:-1] + bytes([blob[-1] ^ 0xFF]))
    cache._STALE_DIGESTS.clear()
    again = warm_registry(cache_dir, classes=[], device="cpu")
    assert again["libraries"] == {LIB: "refreshed"}
    assert aot.purge_cache(cache_dir) == 2 and aot.cache_stats(cache_dir)["libraries"] == 0


def test_the_environment_variable_moves_the_build_directory(tmp_path):
    """A process started with ``METRICS_TPU_TORCH_KERNEL_CACHE`` builds there, and a second builds nothing."""
    env = dict(os.environ, METRICS_TPU_TORCH_KERNEL_CACHE=str(tmp_path / "k"), PYTHONPATH=ROOT)
    code = ("import json; from metrics_tpu_torch.aot.warm import warm_registry; "
            "print(json.dumps(warm_registry(classes=[], device='cpu')))")
    runs = [json.loads(subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                                      timeout=300, check=True).stdout.splitlines()[-1]) for _ in range(2)]
    assert [r["libraries"]["rle_codec"] for r in runs] == ["built", "hit"]
    assert runs[0]["directory"] == str(tmp_path / "k")
