"""Write the PyTorch port's copy of the packaged sim_demo weights.

Reads the JAX package's checkpoint through
``debvader_tpu.load_deblender('sim_demo')`` and writes
``debvader_tpu_torch/data/weights/sim_demo.npz``: one float32 array per
flax key path ("params/encoder/Conv_0/kernel", "batch_stats/..."),
8,318,452 values in all.  The port maps the key paths onto its modules at
load time (debvader_tpu_torch/weights.py), so it needs neither JAX nor
orbax.

    python scripts/convert_sim_demo_to_torch.py [--out PATH]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
OUT = ROOT / "debvader_tpu_torch" / "data" / "weights" / "sim_demo.npz"


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=OUT)
    args = parser.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import debvader_tpu as dt
    from debvader_tpu_torch.weights import flatten_flax

    _, variables = dt.load_deblender("sim_demo")
    flat = flatten_flax(jax.tree_util.tree_map(np.asarray, variables))
    total = sum(v.size for v in flat.values())
    if total != 8_318_452:
        raise SystemExit(f"unexpected parameter count {total}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **flat)
    print(f"wrote {len(flat)} arrays, {total} values, to {args.out}")


if __name__ == "__main__":
    main()
