"""Write ``tests/data/orbax_lm/``: a small LM bundle in the JAX package's
orbax layout, for the port to read where JAX, orbax and tensorstore are not
installed (``chip_smoke.phase_orbax_bundle`` on the card's machine, and
``tests/test_torch_orbax.py`` here).

    JAX_PLATFORMS=cpu python tests/make_orbax_fixture.py [--seed 0] [--out DIR]

The bundle is what the JAX package's ``export_bundle`` writes for params
sharded across processes: ``params/`` by its ``save_checkpoint`` (jax.Array
leaves; the matrices split over two CPU devices along their first axis, so
they are stored as two zarr chunks each) and ``bundle.json``.  The model is
the JAX ``Transformer``: f32, 2 layers, 2 heads of 64, d_model 64, d_ff
128, vocab 128, weights from ``model.init`` at ``--seed`` with the norm
scales randomised too (so a transposed or misnamed scale cannot hide).
``expected.json`` holds each leaf's path, dtype, shape and the SHA-256 of
its bytes as the JAX package's ``load_bundle`` returns them, the token ids
(``--seed``) and the JAX forward's logits on them (``logits.npy``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIG = {"model": "transformer", "vocab_size": 128, "d_model": 64, "n_layers": 2,
          "n_heads": 2, "d_head": 64, "d_ff": 128, "bf16": False}
IDS_SHAPE = (2, 32)
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "orbax_lm")


def leaf_records(params) -> list[dict]:
    """Path, dtype, shape and SHA-256 of each leaf (paths ``a/b/c``)."""
    import numpy as np

    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}" if path else k)
            return
        a = np.ascontiguousarray(np.asarray(node))
        out.append({"path": path, "dtype": str(a.dtype), "shape": list(a.shape),
                    "sha256": hashlib.sha256(a.tobytes()).hexdigest()})

    walk(params, "")
    return out


def build(seed: int, out: str) -> None:
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from tensorflowonspark_tpu import checkpoint as jckpt
    from tensorflowonspark_tpu.models import transformer as jtfm

    model = jtfm.build_transformer(CONFIG)
    ids = np.random.RandomState(seed).randint(
        0, CONFIG["vocab_size"], IDS_SHAPE).astype(np.int32)
    params = model.init(jax.random.PRNGKey(seed), ids[:1])["params"]
    rng = np.random.RandomState(seed + 1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (np.asarray(x) * (1 + 0.1 * rng.randn(*x.shape))).astype(np.float32)
        if "scale" in str(p[-1]) else np.asarray(x), params)
    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))

    def place(a):  # split dim 0 over the two devices where it divides
        spec = PartitionSpec("x") if a.ndim >= 2 and a.shape[0] % 2 == 0 else PartitionSpec()
        return jax.device_put(a, NamedSharding(mesh, spec))

    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    jckpt.save_checkpoint(os.path.join(out, "params"), jax.tree.map(place, params))
    with open(os.path.join(out, "bundle.json"), "w") as f:
        json.dump(CONFIG, f, indent=2, sort_keys=True)
    loaded, _ = jckpt.load_bundle(out)
    logits = np.asarray(model.apply({"params": loaded}, ids), np.float32)
    np.save(os.path.join(out, "logits.npy"), logits)
    with open(os.path.join(out, "expected.json"), "w") as f:
        json.dump({"seed": seed, "config": CONFIG, "leaves": leaf_records(loaded),
                   "ids": ids.tolist(), "logits": "logits.npy",
                   "logits_shape": list(logits.shape)}, f, indent=1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    build(args.seed, args.out)
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(args.out) for f in fs)
    print(f"wrote {args.out}: {total} bytes")


if __name__ == "__main__":
    main()
