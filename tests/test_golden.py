"""Golden-image regression tests (SURVEY.md §4): committed framebuffers of
the seeded fixture meshes, rendered by the brute-force `fixed` oracle
(tests/golden/make_golden.py). Catches end-to-end shading / tonemap /
compose / traversal regressions that per-stage unit tests miss.

Tolerance: tonemapping rounds to uint8, so tiny numeric drift (XLA version,
fusion order) may flip the LSB on isolated pixels — allow <=2 LSB on <=1%%
of pixels, exact elsewhere. Cross-method comparisons also allow hit-
selection ties (<2% of pixels off by >2 LSB).
"""

import os

import numpy as np

from meshes import render_golden

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "golden_frames.npz")


def _check(img, want):
    assert img.shape == want.shape and img.dtype == want.dtype
    diff = np.abs(img.astype(np.int16) - want.astype(np.int16))
    frac_off = (diff > 0).mean()
    assert diff.max() <= 2, f"max pixel delta {diff.max()}"
    assert frac_off <= 0.01, f"{frac_off:.4f} of pixels differ"


def _check_cross(img, want):
    diff = np.abs(img.astype(np.int16) - want.astype(np.int16))
    assert (diff > 2).mean() < 0.02, f"{(diff > 2).mean():.4f} pixels off"


def test_golden_tester_fixed(tester_path):
    want = np.load(GOLDEN)["tester_fixed"]
    img = render_golden(tester_path, 128, 72, "fixed", chunk=512)
    _check(img, want)


def test_golden_rabbit_grid(rabbit_path):
    """The cluster path against the oracle's frame of the same view."""
    want = np.load(GOLDEN)["rabbit_fixed"]
    img = render_golden(rabbit_path, 96, 54, "grid", leaf_size=64,
                        tile_h=6, tile_w=32, max_candidates=32)
    _check(img, want)


def test_golden_tester_bin_matches_fixed_golden(tester_path):
    """The main bin path (the one bench.py measures) against the
    committed fixed-path frame."""
    want = np.load(GOLDEN)["tester_fixed"]
    img = render_golden(tester_path, 128, 72, "bin", tile_h=16, tile_w=16,
                        bin_chunk=64)
    _check_cross(img, want)


def test_golden_tester_raster_matches_fixed_golden(tester_path):
    """The raster path against the committed fixed-path frame."""
    want = np.load(GOLDEN)["tester_fixed"]
    img = render_golden(tester_path, 128, 72, "raster")
    _check_cross(img, want)


def test_golden_tester_bin_exact(tester_path):
    """The main bin path pinned against the oracle's frame at the TIGHT
    tolerance (<=2 LSB on <=1% of pixels): the cross-method allowance
    above could hide a bin-only regression."""
    want = np.load(GOLDEN)["tester_fixed"]
    img = render_golden(tester_path, 128, 72, "bin", tile_h=16, tile_w=16,
                        bin_chunk=16)
    _check(img, want)


def test_golden_rabbit_bin_exact(rabbit_path):
    """The bin path on the clustered-density mesh, tight tolerance."""
    want = np.load(GOLDEN)["rabbit_fixed"]
    img = render_golden(rabbit_path, 96, 54, "bin", bin_chunk=16)
    _check(img, want)
