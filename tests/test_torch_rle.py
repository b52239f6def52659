"""The port's RLE codec against the JAX package's, the hand-derived golden vectors and the independent codec.

The compressed bytes must be the JAX package's (and pycocotools'), byte for
byte: on random masks, through the batch encoder that finds the runs with
torch ops, and for every mask of a batch at once. The C++ codec must equal its
plain Python version, including on malformed strings and on values of every
width, and a failed build must raise.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from metrics_tpu.detection import rle as jrle
from metrics_tpu_torch.detection import rle as trle
from metrics_tpu_torch.ops import _native
from tests import _independent_rle as ind
from tests.test_rle_independent import GOLDEN


@pytest.mark.parametrize(("mask", "counts", "compressed"), GOLDEN)
def test_golden_vectors(mask, counts, compressed):
    mask = np.asarray(mask, dtype=np.uint8)
    assert trle.mask_to_rle(mask, compress=False)["counts"] == counts
    assert trle.mask_to_rle(torch.from_numpy(mask))["counts"] == compressed
    assert trle.compress_counts(counts) == trle._compress_counts_plain(counts) == compressed
    assert trle.decompress_counts(compressed).tolist() == trle._decompress_counts_plain(compressed).tolist() == counts
    np.testing.assert_array_equal(trle.rle_to_mask({"size": mask.shape, "counts": compressed}), mask)
    np.testing.assert_array_equal(trle._expand_plain(np.asarray(counts), *mask.shape), mask)


def _blocky(rng, shape):
    """Long runs (several 5-bit groups) sprinkled with short ones."""
    base = rng.rand(-(-shape[0] // 4), -(-shape[1] // 4)) > 0.5
    mask = np.kron(base, np.ones((4, 4)))[: shape[0], : shape[1]].astype(np.uint8)
    return mask ^ (rng.rand(*shape) > 0.95).astype(np.uint8)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (13, 29), (64, 64), (5, 300)])
def test_bytes_equal_the_reference_on_random_masks(seed, shape):
    mask = _blocky(np.random.RandomState(seed), shape)
    ours = trle.mask_to_rle(mask)
    assert ours == jrle.mask_to_rle(mask)
    assert ours["counts"] == ind.encode_mask(mask)["counts"]
    assert trle.mask_to_rle(mask, compress=False) == jrle.mask_to_rle(mask, compress=False)
    np.testing.assert_array_equal(trle.rle_to_mask(ours), mask)
    np.testing.assert_array_equal(trle.rle_to_mask(jrle.mask_to_rle(mask, compress=False)), mask)
    assert trle.rle_area(ours)[0] == jrle.rle_area(ours)[0] == ind.rle_area(ours) == mask.sum()


@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.int64, torch.float32])
def test_batch_encoder_equals_the_reference_mask_by_mask(dtype):
    rng = np.random.RandomState(5)
    masks = np.stack([_blocky(rng, (11, 17)) for _ in range(9)])
    masks[0] = 0  # one run
    masks[1] = 1  # an empty background run, then one run
    masks[2, 0, 0], masks[3, 0, 0] = 1, 0  # the first pixel set and unset
    got = trle.masks_to_rles(torch.from_numpy(masks).to(dtype))
    assert got == [jrle.mask_to_rle(m) for m in masks]
    assert trle.masks_to_rles(masks, compress=False) == [jrle.mask_to_rle(m, compress=False) for m in masks]


def test_batch_encoder_on_empty_batches_and_planes():
    assert trle.masks_to_rles(torch.zeros((0, 4, 5), dtype=torch.bool)) == []
    assert trle.masks_to_rles([]) == [jrle.mask_to_rle(m) for m in np.asarray([])] == []
    for shape in [(2, 0, 5), (2, 4, 0)]:
        got = trle.masks_to_rles(torch.zeros(shape, dtype=torch.bool))
        assert got == [jrle.mask_to_rle(np.zeros(shape[1:], np.uint8))] * 2
    with pytest.raises(ValueError, match="2d mask"):
        trle.mask_to_rle(np.zeros((2, 3, 4)))


def test_codec_equals_its_plain_version_on_counts_of_every_width():
    rng = np.random.RandomState(6)
    for trial in range(40):
        n = rng.randint(0, 30)
        width = rng.choice([3, 12, 31, 50, 62])
        counts = rng.randint(-(1 << int(width)), 1 << int(width), n, dtype=np.int64)
        if trial == 0:
            counts = np.asarray([np.iinfo(np.int64).max, np.iinfo(np.int64).min, 0, -1, 1], np.int64)
        data = trle.compress_counts(counts)
        assert data == trle._compress_counts_plain(counts) == jrle.compress_counts(counts)
        np.testing.assert_array_equal(trle.decompress_counts(data), trle._decompress_counts_plain(data))
        np.testing.assert_array_equal(trle.decompress_counts(data), counts)
        np.testing.assert_array_equal(trle.decompress_counts(data.decode("ascii")), counts)


@pytest.mark.parametrize("data", [b"0" + bytes([48 + 0x20]), bytes([48 + 0x20] * 13) + b"0"])
def test_malformed_strings_raise_in_the_codec_and_its_plain_version(data):
    for decode in (trle.decompress_counts, trle._decompress_counts_plain, jrle.decompress_counts):
        with pytest.raises(ValueError, match="truncated|malformed"):
            decode(data)


def test_expand_checks_the_run_total():
    for expand in (trle._expand, trle._expand_plain):
        with pytest.raises(ValueError, match="expected 12"):
            expand(np.asarray([3, 4]), 3, 4)
    np.testing.assert_array_equal(trle._expand(np.asarray([2, 5, 5]), 3, 4),
                                  trle._expand_plain(np.asarray([2, 5, 5]), 3, 4))


def test_rle_iou_equals_the_reference_and_the_independent_codec():
    rng = np.random.RandomState(11)
    masks = (rng.rand(7, 30, 34) > 0.6).astype(np.uint8)
    masks[6] = 0  # an empty detection: IoU 0, not NaN
    dts = trle.masks_to_rles(masks[[0, 1, 2, 6]])
    gts = trle.masks_to_rles(masks[3:6])
    crowd = [False, True, False]
    got = trle.rle_iou(dts, gts, crowd)
    np.testing.assert_array_equal(got, jrle.rle_iou(dts, gts, crowd))
    np.testing.assert_allclose(got, ind.mask_iou(dts, gts, crowd), atol=1e-12)
    assert trle.rle_iou([], gts, crowd).shape == (0, 3)


def test_codec_library_is_keyed_by_its_source(tmp_path, monkeypatch):
    first = _native.library_path("rle_codec")
    assert first.parent == _native.BUILD_DIR and first.name.startswith("librle_codec-")
    fake = tmp_path / "csrc"
    fake.mkdir()
    (fake / "rle_codec.cpp").write_text((_native.CSRC / "rle_codec.cpp").read_text() + "\n// edited\n")
    monkeypatch.setattr(_native, "CSRC", fake)
    assert _native.library_path("rle_codec") != first


def test_a_failed_codec_build_raises(tmp_path, monkeypatch):
    """No compiler, or a source that does not compile: the codec raises instead of falling back."""
    monkeypatch.setattr(_native, "_loaded", {})
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        trle.compress_counts([1, 2])
    monkeypatch.undo()
    monkeypatch.setattr(_native, "_loaded", {})
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    broken = tmp_path / "csrc"
    broken.mkdir()
    (broken / "rle_codec.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_native, "CSRC", broken)
    with pytest.raises(RuntimeError, match="failed for csrc/rle_codec.cpp"):
        trle.decompress_counts(b"414")
    assert not list((tmp_path / "build").glob("*.so"))
