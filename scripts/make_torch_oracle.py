"""Write the JAX oracle that the PyTorch port's frontend is gated against.

Renders the 3 textured stereo pairs that ``scripts/verify_tpu.py`` uses
(``apps.benchmark_system.make_sequence(3, 480, 752, seed=3, texture=0.1)``),
quantizes them to uint8, and runs ``__graft_entry__.entry(dtype=float32)`` on
the CPU over ``frames / 255``. Stores the frames and the entry() outputs the
frontend metrics read (keypoints, kp mask, idx1, lines, line mask, junctions,
junction mask) in ``tests/data/torch_frontend_oracle.npz``.

    JAX_PLATFORMS=cpu python scripts/make_torch_oracle.py

``chip_smoke.py`` and ``tests/test_torch_slice.py`` read the file; the port
itself never imports JAX.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

OUT = os.path.join(REPO, "tests", "data", "torch_frontend_oracle.npz")
N_PAIRS = 3
FRAME_SEED = 3
# entry() tuple slots the metrics need: kp0, kp1, idx1, lines0, line_mask0,
# kp_mask0, junctions (both views), junction mask (both views)
KEEP = (0, 1, 2, 4, 5, 7, 8, 10)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from __graft_entry__ import entry
    from apps.benchmark_system import make_sequence

    _, L, R, _ = make_sequence(N_PAIRS, 480, 752, seed=FRAME_SEED, texture=0.1)
    frames = np.stack([np.stack([L[i], R[i]]) for i in range(N_PAIRS)])
    frames_u8 = np.clip(np.rint(frames * 255.0), 0, 255).astype(np.uint8)
    blob = {"frames_u8": frames_u8}

    fn, args = entry(dtype=jnp.float32)
    plp, loip, lgp, _ = args
    fnj = jax.jit(fn)
    for i in range(N_PAIRS):
        pair = jnp.asarray(frames_u8[i].astype(np.float32) / np.float32(255.0))
        out = fnj(plp, loip, lgp, pair)
        for j in KEEP:
            blob[f"p{i}_o{j}"] = np.asarray(out[j])
        print(f"pair {i}: kps={int(np.asarray(out[7]).sum())} "
              f"lines={int(np.asarray(out[5]).sum())} "
              f"matches={int((np.asarray(out[2]) >= 0).sum())}")

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **blob)
    print(f"oracle written: {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
