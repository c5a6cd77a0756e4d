"""Circuit-class matrix (MC64-requiring) with compressed tile storage.

    python examples/run_circuit_compressed.py
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax

# the f64 compressed store needs x64 buffers
jax.config.update("jax_enable_x64", True)

import numpy as np

from pangulu_jax.api import InitOptions, finalize, gssv, init
from pangulu_jax.models import circuit
from pangulu_jax.utils.perf import residual_norm


def main():
    a = circuit(3000, seed=4)
    b = np.asarray(a.to_scipy() @ np.ones(a.n))
    h = init(a, InitOptions(nb=32, dtype="r64", ordering="mindeg",
                            tile_storage="compressed"))
    x = gssv(h, b)
    st = h.factor_tiles
    print(f"HBM: {st.compressed_bytes / 2**20:.1f} MiB compressed vs "
          f"{st.dense_bytes / 2**20:.1f} MiB dense "
          f"({st.dense_bytes / st.compressed_bytes:.1f}x)")
    print("residual:", residual_norm(a.to_scipy(), x, b))
    finalize(h)


if __name__ == "__main__":
    main()
