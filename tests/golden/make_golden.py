"""Regenerate tests/golden/golden_frames.npz from the brute-force `fixed`
oracle on the seeded fixture meshes (tests/meshes.py).

    JAX_PLATFORMS=cpu python tests/golden/make_golden.py

Run it only when a deliberate rendering change lands; the golden tests
compare every intersection method against these frames.
"""

import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import meshes  # noqa: E402

# (key, writer, resolution) — the goldens the tests read
FRAMES = [("tester_fixed", meshes.write_tester, (128, 72)),
          ("rabbit_fixed", meshes.write_rabbit, (96, 54))]


def main():
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for key, write, (w, h) in FRAMES:
            path = os.path.join(tmp, key + ".ply")
            write(path)
            out[key] = meshes.render_golden(path, w, h, "fixed", chunk=512)
            print(key, out[key].shape, f"hit px {(out[key] != [240, 130, 0]).any(-1).mean():.3f}")
    np.savez_compressed(os.path.join(HERE, "golden_frames.npz"), **out)


if __name__ == "__main__":
    main()
