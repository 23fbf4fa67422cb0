"""Write the PyTorch port's copy of the packaged int8 serving bundle.

Reads the JAX package's calibrated, QAT-fine-tuned bundle
``debvader_tpu/data/weights/sim_demo_int8/`` (meta.json and an orbax tree)
through ``debvader_tpu.models.quantized.load_quantized`` and writes
``debvader_tpu_torch/data/weights/sim_demo_int8.npz`` and
``sim_demo_int8.json`` through ``debvader_tpu_torch.weights.
quantized_from_jax``: every leaf of the orbax tree, bit for bit: the
QAT-fine-tuned float variables (8.3 M float32 values), the 18 int8 kernels
in the port's layouts (7.5 M values) beside their float32 scales, and the
per-channel activation scales; the meta.json keys as the JAX package wrote
them.  The npz is compressed (36 MB; 41 MB of arrays).  Needs JAX and
orbax, so it runs where the JAX package does, once:

    python scripts/convert_sim_demo_int8_to_torch.py [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
SRC = ROOT / "debvader_tpu" / "data" / "weights" / "sim_demo_int8"
OUT = ROOT / "debvader_tpu_torch" / "data" / "weights" / "sim_demo_int8"


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=OUT, help="path without suffix; .npz and .json are written")
    args = parser.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from debvader_tpu.models.quantized import load_quantized
    from debvader_tpu_torch.weights import quantized_from_jax

    qv = load_quantized(SRC)
    arrays, meta = quantized_from_jax(qv)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out.with_suffix(".npz"), **arrays)
    args.out.with_suffix(".json").write_text(json.dumps(meta, indent=1))
    n8 = sum(a.size for a in arrays.values() if a.dtype == np.int8)
    nf = sum(a.size for a in arrays.values() if a.dtype == np.float32)
    print(f"wrote {len(arrays)} arrays ({n8} int8 and {nf} float32 values) to {args.out.with_suffix('.npz')}")


if __name__ == "__main__":
    main()
