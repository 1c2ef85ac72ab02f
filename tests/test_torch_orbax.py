"""The port's reader of the JAX package's orbax checkpoints and bundles
(``tensorflowonspark_torch/orbax_layout/``) against oracles that the card's
machine does not have: ``zstandard`` for the hand-written zstd decoder,
``tensorstore`` for the OCDBT reader, and the JAX package's own
``restore_checkpoint`` / ``load_bundle`` for the trees.  Every comparison
is exact (bytes, dtypes, shapes, containers), except the logits, which are
held at the tolerance of ``tests/test_torch_transformer.py``.

Also: the committed fixture ``tests/data/orbax_lm/`` (written by
``tests/make_orbax_fixture.py``) against the JAX package, and
``chip_smoke.phase_orbax_bundle`` shrunk onto the CPU in a fresh process
that loads neither JAX nor any of the oracles."""

import hashlib
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tensorflowonspark_torch import checkpoint as tckpt
from tensorflowonspark_torch.models import registry as treg
from tensorflowonspark_torch.orbax_layout import restore_tree, zarr2, zstd
from tensorflowonspark_torch.orbax_layout.ocdbt import OcdbtStore
from tensorflowonspark_tpu import checkpoint as jckpt
from tensorflowonspark_tpu.models import transformer as jtfm

zstandard = pytest.importorskip("zstandard")
tensorstore = pytest.importorskip("tensorstore")

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "data" / "orbax_lm"


# -- the zstd decoder against zstandard ----------------------------------------

def _data(kind: str) -> bytes:
    rng = np.random.default_rng(7)
    if kind == "low":  # 2 bits of entropy a byte
        return rng.integers(0, 4, 200_000, dtype=np.uint8).tobytes()
    if kind == "middle":  # short repeats of random bytes, words
        words = [rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8).tobytes()
                 for _ in range(300)]
        return b" ".join(words[i] for i in rng.integers(0, 300, 40_000))
    if kind == "high":
        return rng.integers(0, 256, 150_000, dtype=np.uint8).tobytes()
    if kind == "runs":  # runs longer than a block (128 KB)
        return b"a" * 300_000 + rng.integers(0, 256, 1000, dtype=np.uint8).tobytes() + b"b" * 140_000
    if kind == "cross_block":  # matches that reach back into earlier blocks
        base = rng.integers(0, 256, 60_000, dtype=np.uint8).tobytes()
        return base + rng.integers(0, 256, 150_000, dtype=np.uint8).tobytes() + base + base[:999]
    if kind == "floats":  # what orbax chunks hold
        return rng.standard_normal(60_000).astype(np.float32).tobytes()
    raise KeyError(kind)


KINDS = ("low", "middle", "high", "runs", "cross_block", "floats")
LEVELS = (-5, 1, 3, 9, 19)


@pytest.mark.parametrize("content_size,checksum", [(True, True), (True, False),
                                                   (False, True), (False, False)])
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("kind", KINDS)
def test_decoder_matches_zstandard(kind, level, content_size, checksum):
    data = _data(kind)
    if level == 19 and kind in ("low", "middle"):
        data = data[:60_000]  # level 19 is slow to compress; the decode is what is tested
    cctx = zstandard.ZstdCompressor(level=level, write_content_size=content_size,
                                    write_checksum=checksum)
    frame = cctx.compress(data)
    assert zstandard.ZstdDecompressor().decompressobj().decompress(frame) == data
    assert zstd.decompress(frame) == data
    out = bytearray(len(data))
    assert zstd.decompress_into(frame, out) == len(data) and bytes(out) == data


@pytest.mark.parametrize("kind", KINDS)
def test_decoder_streaming_frames(kind):
    """The streaming form (no content size; flushed blocks mixing raw and
    compressed ones), as orbax's chunk frames are written."""
    data = _data(kind)
    cobj = zstandard.ZstdCompressor(level=3, write_checksum=True).compressobj()
    parts = [cobj.compress(data[i:i + 7000]) + cobj.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)
             for i in range(0, len(data), 7000)]
    frame = b"".join(parts) + cobj.flush()
    assert zstd.content_size(frame) is None
    assert zstd.decompress(frame) == data  # "runs": a first guess too small, a second pass


def test_decoder_concatenated_and_skippable_frames():
    pieces = [_data("floats")[:5000], b"", _data("middle")[:9000], _data("runs")[:200]]
    frames = [zstandard.ZstdCompressor(level=lv, write_content_size=lv % 2 == 0).compress(p)
              for lv, p in zip((1, 2, 3, 4), pieces)]
    skippable = (0x184D2A53).to_bytes(4, "little") + (11).to_bytes(4, "little") + b"x" * 11
    blob = frames[0] + skippable + frames[1] + frames[2] + skippable + frames[3]
    assert zstd.decompress(blob) == b"".join(pieces)
    assert zstd.content_size(frames[1] + frames[3]) == len(pieces[1]) + len(pieces[3])


def test_decoder_corrupt_checksum_raises():
    frame = bytearray(zstandard.ZstdCompressor(write_checksum=True).compress(_data("middle")))
    frame[-1] ^= 0x40
    with pytest.raises(ValueError, match="checksum mismatch"):
        zstd.decompress(bytes(frame))


def test_decoder_dictionary_frames_raise():
    """A frame compressed with a trained dictionary names its id; so does a
    frame whose header carries a hand-set dictionary id."""
    rng = np.random.default_rng(1)
    samples = [b"key=%d value=%s;" % (i, rng.integers(97, 123, 12, dtype=np.uint8).tobytes())
               for i in range(400)]
    dict_data = zstandard.train_dictionary(1024, samples)
    frame = zstandard.ZstdCompressor(dict_data=dict_data).compress(samples[3] * 3)
    with pytest.raises(ValueError, match=f"dictionary {dict_data.dict_id()}"):
        zstd.decompress(frame)
    plain = bytearray(zstandard.ZstdCompressor(write_content_size=False).compress(b"abc" * 50))
    plain[4] |= 1  # Dictionary_ID_flag 1: one byte of id after the window descriptor
    plain.insert(6, 42)
    with pytest.raises(ValueError, match="dictionary 42"):
        zstd.decompress(bytes(plain))


def _valid_frames() -> list[bytes]:
    out = []
    for kind in KINDS:
        data = _data(kind)[:20_000]
        for level in (1, 9):
            out.append(zstandard.ZstdCompressor(level=level, write_checksum=True,
                                                write_content_size=level == 1).compress(data))
    return out


FRAMES = _valid_frames()
ORIGINALS = [zstandard.ZstdDecompressor().decompressobj().decompress(f) for f in FRAMES]


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(which=st.integers(0, len(FRAMES) - 1), cut=st.integers(0, 10 ** 6),
       flips=st.lists(st.tuples(st.integers(0, 10 ** 6), st.integers(1, 255)), max_size=4))
def test_decoder_truncated_or_flipped_raises_value_error(which, cut, flips):
    """A truncated frame raises ``ValueError``; a frame with flipped bytes
    raises it or (a flip the format does not see, such as in the window
    descriptor's mantissa) decodes to the original, its checksum held."""
    frame = bytearray(FRAMES[which])
    if not flips:
        del frame[cut % len(frame):]
        with pytest.raises(ValueError):
            zstd.decompress(bytes(frame))
        return
    for at, mask in flips:
        frame[at % len(frame)] ^= mask
    try:
        got = zstd.decompress(bytes(frame))
    except ValueError:
        return
    assert got == ORIGINALS[which]


def test_decoder_never_crashes_on_mutations_in_a_subprocess():
    """Thousands of seeded truncations, flips and splices in a fresh
    process: each raises ``ValueError`` or decodes to the original, and the
    process exits normally (a crash would end it by a signal)."""
    code = textwrap.dedent(f"""
        import sys, random
        sys.path.insert(0, {str(REPO)!r})
        import zstandard
        from tensorflowonspark_torch.orbax_layout import zstd
        rng = random.Random(5)
        frames = []
        for n, level in ((3000, 1), (40000, 3), (70000, 19), (200, 9)):
            data = bytes(rng.getrandbits(8) % (4 if level == 3 else 256) for _ in range(n))
            data = data * 2
            frames.append((zstandard.ZstdCompressor(level=level, write_checksum=True)
                           .compress(data), data))
        raised = same = 0
        for i in range(3000):
            frame, data = frames[i % len(frames)]
            f = bytearray(frame)
            op = rng.randrange(3)
            if op == 0:
                del f[rng.randrange(len(f)):]
            elif op == 1:
                for _ in range(rng.randrange(1, 6)):
                    f[rng.randrange(len(f))] ^= rng.randrange(1, 256)
            else:
                a = rng.randrange(len(f))
                f[a:a] = bytes(rng.getrandbits(8) for _ in range(rng.randrange(1, 40)))
            try:
                got = zstd.decompress(bytes(f))
            except ValueError:
                raised += 1
                continue
            assert got == data, i
            same += 1
        print(raised, same)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    raised, same = map(int, out.stdout.split())
    assert raised + same == 3000 and raised > 2500


# -- checkpoints the JAX package writes ----------------------------------------

def _trees() -> dict:
    rng = np.random.default_rng(3)
    return {
        "numpy": {"a": rng.standard_normal((5, 7)).astype(np.float32),
                  "b": {"c": np.arange(3, dtype=np.int32), "d": rng.integers(0, 9, (2, 3))}},
        "jax_array": {"w": jnp.asarray(rng.standard_normal((4, 6)), jnp.float32),
                      "v": jnp.arange(5, dtype=jnp.int32)},
        "tuple": {"t": (np.ones(2, np.float32), np.arange(3, dtype=np.int64)),
                  "n": [(np.zeros(1, np.float64),), np.full((2,), 3, np.uint8)]},
        "python_scalar": {"step": 3, "lr": 0.5, "flag": True},
        "bf16": {"w": jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16),
                 "n": rng.standard_normal(4).astype(ml_dtypes.bfloat16)},
        "zero_d": {"x": np.float32(2.5), "y": np.array(7, np.int16),
                   "z": jnp.asarray(1.25, jnp.float32)},
        "all_zero": {"z": np.zeros((64, 33), np.float32), "i": np.zeros(5, np.int8)},
        "empty": {"e": {}, "l": [], "none": None, "k": {"x": np.array([True, False])}},
    }


TREES = tuple(_trees())


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Each tree of ``_trees`` saved by the JAX package's ``save_checkpoint``."""
    root = tmp_path_factory.mktemp("orbax_trees")
    paths = {}
    for name, tree in _trees().items():
        paths[name] = str(root / name)
        jckpt.save_checkpoint(paths[name], tree)
    return paths


def _tensorstore_items(path: str) -> dict:
    kv = tensorstore.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/"}).result()
    return {k.decode(): bytes(kv.read(k).result().value) for k in kv.list().result()}


def _assert_same_tree(got, want, where=""):
    """Containers, dtypes, shapes and bytes equal; the port's bfloat16 /
    float8 leaves are torch tensors of the dtype that ml_dtypes names."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _assert_same_tree(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{where}/{i}")
    elif want is None:
        assert got is None, where
    else:
        want = np.asarray(want)
        if isinstance(got, torch.Tensor):
            assert str(got.dtype) == f"torch.{want.dtype.name}", (where, got.dtype, want.dtype)
            bits = torch.uint16 if got.element_size() == 2 else torch.uint8
            got = got.view(bits).numpy()
            want = want.view(got.dtype)
        assert isinstance(got, np.ndarray), (where, type(got))
        assert got.dtype == want.dtype and got.shape == want.shape, (where, got.dtype, want.dtype)
        assert got.tobytes() == want.tobytes(), where


@pytest.mark.parametrize("name", TREES)
def test_ocdbt_keys_and_values_match_tensorstore(written, name):
    store = OcdbtStore(written[name])
    want = _tensorstore_items(written[name])
    assert store.list() == sorted(want)
    for key, value in want.items():
        assert store.read(key) == value, key


@pytest.mark.parametrize("name", TREES)
def test_restore_tree_matches_jax_restore_checkpoint(written, name):
    _assert_same_tree(restore_tree(written[name]), jckpt.restore_checkpoint(written[name]))
    _assert_same_tree(tckpt.restore_checkpoint(written[name]),
                      jckpt.restore_checkpoint(written[name]))


def test_ocdbt_interior_nodes_match_tensorstore(tmp_path):
    """A database with a B-tree several levels deep (tiny nodes), keys
    sharing long prefixes, inline and indirect values."""
    kv = tensorstore.KvStore.open({
        "driver": "ocdbt", "base": f"file://{tmp_path}/",
        "config": {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 16}}).result()
    rng = np.random.default_rng(11)
    with tensorstore.Transaction() as txn:
        for i in range(300):
            key = f"layer_{i % 7}/w.{i:04d}/{'x' * (i % 5)}"
            kv.with_transaction(txn)[key] = rng.integers(0, 256, int(rng.integers(0, 60)),
                                                         dtype=np.uint8).tobytes()
    kv[b"later"] = b"a second version"
    want = _tensorstore_items(str(tmp_path))
    store = OcdbtStore(str(tmp_path))
    assert store.list() == sorted(want) and len(want) == 301
    assert all(store.read(k) == v for k, v in want.items())


def test_ocdbt_corrupt_node_raises(written, tmp_path):
    import shutil

    path = tmp_path / "copy"
    shutil.copytree(written["numpy"], path)
    manifest = path / "manifest.ocdbt"
    raw = bytearray(manifest.read_bytes())
    raw[20] ^= 1
    manifest.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC-32C"):
        OcdbtStore(str(path))


def test_chunked_array_with_edge_and_missing_chunks(tmp_path):
    """Zarr arrays of 8x4 chunks over a 37x11 shape (edge chunks stored at
    full size), written by tensorstore into an orbax checkpoint's database:
    ``m`` over the tree's own leaf, against the JAX package's restore; ``n``
    with a band of all-zero chunks, which tensorstore does not store (the
    reader takes the fill value), against tensorstore's read."""
    path = str(tmp_path / "ckpt")
    jckpt.save_checkpoint(path, {"m": np.zeros((37, 11), np.float32)})
    rng = np.random.default_rng(5)
    arrays = {}
    for name in ("m", "n"):
        data = rng.standard_normal((37, 11)).astype(np.float32)
        if name == "n":
            data[8:16] = 0.0
        arrays[name] = tensorstore.open({
            "driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{path}/"},
            "path": name, "metadata": {"shape": [37, 11], "chunks": [8, 4], "dtype": "<f4",
                                       "fill_value": 0.0,
                                       "compressor": {"id": "zstd", "level": 3}},
            "create": True, "delete_existing": True}).result()
        arrays[name].write(data).result()
    store = OcdbtStore(path)
    keys = store.list()
    assert "m/4.2" in keys and "n/4.2" in keys and "n/1.0" not in keys
    got = restore_tree(path)
    np.testing.assert_array_equal(got["m"], arrays["m"].read().result())
    _assert_same_tree(got, jckpt.restore_checkpoint(path))
    n = zarr2.read_array(lambda k: store.read(k) if k in store else None, "n")
    want = arrays["n"].read().result()
    assert n.dtype == want.dtype and n.tobytes() == want.tobytes()


def test_zarr_fill_values_and_refusals():
    meta = {"zarr_format": 2, "shape": [5], "chunks": [2], "dtype": "<f8", "order": "C",
            "compressor": None, "filters": None, "fill_value": 1.5}
    values = {"a/.zarray": json.dumps(meta).encode(),
              "a/1": np.array([3.0, 4.0]).tobytes()}
    got = zarr2.read_array(values.get, "a")
    np.testing.assert_array_equal(got, [1.5, 1.5, 3.0, 4.0, 1.5])
    null = {**values, "a/.zarray": json.dumps({**meta, "fill_value": None}).encode()}
    np.testing.assert_array_equal(zarr2.read_array(null.get, "a"), [0.0, 0.0, 3.0, 4.0, 0.0])
    for field, value, match in (("filters", [{"id": "delta"}], "filters"),
                                ("order", "F", "order"),
                                ("compressor", {"id": "blosc"}, "compressor"),
                                ("dtype", "<c8", "dtype")):
        bad = {**values, "a/.zarray": json.dumps({**meta, field: value}).encode()}
        with pytest.raises(ValueError, match=match):
            zarr2.read_array(bad.get, "a")


def test_use_ocdbt_false_layout(tmp_path):
    import orbax.checkpoint as ocp

    tree = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": [np.ones(2, np.int32), jnp.asarray([1.0, 2.0], jnp.bfloat16)]}
    path = str(tmp_path / "plain")
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False)).save(path, tree)
    assert not os.path.exists(os.path.join(path, "manifest.ocdbt"))
    _assert_same_tree(restore_tree(path), jckpt.restore_checkpoint(path))


def test_zarr3_raises_naming_it(tmp_path):
    path = tmp_path / "z3"
    path.mkdir()
    (path / "_METADATA").write_text(json.dumps({"tree_metadata": {}, "use_zarr3": True}))
    with pytest.raises(ValueError, match="use_zarr3"):
        restore_tree(str(path))


# -- two JAX processes ---------------------------------------------------------

TWO_PROCESS = textwrap.dedent("""
    import os, sys
    pid, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    import jax
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=2, process_id=pid)
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from tensorflowonspark_tpu import checkpoint as c
    mesh = Mesh(np.array(jax.devices()), ("x",))
    full = np.arange(8 * 6, dtype=np.float32).reshape(8, 6) / 7
    bf = (np.arange(4 * 10) / 3).astype(np.float32).reshape(4, 10)
    tree = {"w": jax.make_array_from_process_local_data(
                NamedSharding(mesh, P("x")), full[pid * 4:(pid + 1) * 4], full.shape),
            "b": jax.make_array_from_process_local_data(
                NamedSharding(mesh, P(None, "x")),
                bf[:, pid * 5:(pid + 1) * 5].astype(jax.numpy.bfloat16), bf.shape),
            "h": {"step": np.int64(9)}}
    assert not tree["w"].is_fully_addressable
    c.export_bundle(out, tree, {"model": "x", "width": 6})
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_process_bundle(tmp_path_factory):
    """A bundle the JAX package's ``export_bundle`` wrote collectively from
    two ``jax.distributed`` processes (params not fully addressable: the
    orbax layout, one ``ocdbt.process_<i>`` database each)."""
    work = tmp_path_factory.mktemp("two_process")
    script = work / "two_process.py"
    script.write_text(TWO_PROCESS)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=1"}
    port, out = str(_free_port()), str(work / "bundle")
    procs = [subprocess.Popen([sys.executable, str(script), str(i), port, out], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for i in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        pytest.fail("two-process export failed:\n" + "\n".join(log[-2000:] for log in logs))
    return out


def test_two_process_bundle_reads_whole(two_process_bundle):
    params_dir = os.path.join(two_process_bundle, "params")
    assert not os.path.exists(os.path.join(two_process_bundle, "params.npz"))
    assert sorted(d for d in os.listdir(params_dir) if d.startswith("ocdbt.process_")) == \
        ["ocdbt.process_0", "ocdbt.process_1"]
    store = OcdbtStore(params_dir)
    want = _tensorstore_items(params_dir)
    assert store.list() == sorted(want) and all(store.read(k) == v for k, v in want.items())
    got, config = tckpt.load_bundle(two_process_bundle)
    ref, ref_config = jckpt.load_bundle(two_process_bundle)
    assert config == ref_config == {"model": "x", "width": 6}
    _assert_same_tree(got, ref)
    np.testing.assert_array_equal(got["w"], np.arange(48, dtype=np.float32).reshape(8, 6) / 7)
    assert got["b"].dtype == torch.bfloat16 and tuple(got["b"].shape) == (4, 10)


# -- end to end: an LM bundle and a training checkpoint ------------------------

SMALL = {"model": "transformer", "vocab_size": 64, "d_model": 32, "n_layers": 2,
         "n_heads": 4, "bf16": False, "attn_impl": "pallas_interpret"}


def test_jax_orbax_lm_bundle_scores_in_the_port(tmp_path):
    """A JAX ``Transformer`` bundle in the orbax layout (``save_checkpoint``
    of its params plus ``bundle.json``, as ``export_bundle`` writes it for
    sharded params), loaded by the port's ``load_bundle`` and scored by its
    ``build_apply`` on the CPU against the JAX apply (its Pallas kernel in
    interpret mode) at 1e-4."""
    model = jtfm.build_transformer(SMALL)
    ids = np.random.RandomState(0).randint(0, 64, (2, 16)).astype(np.int32)
    params = model.init(jax.random.PRNGKey(0), ids[:1])["params"]
    export = tmp_path / "bundle"
    jckpt.save_checkpoint(str(export / "params"), params)
    (export / "bundle.json").write_text(json.dumps(SMALL))
    got, config = tckpt.load_bundle(str(export))
    _assert_same_tree(got, jckpt.load_bundle(str(export))[0])
    ref = np.asarray(model.apply({"params": params}, ids))
    out = treg.build_apply(config, device="cpu")(got, ids).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_restore_checkpoint_of_a_jax_training_checkpoint(tmp_path):
    """``restore_checkpoint`` of a JAX orbax training checkpoint (params,
    an optax Adam state of NamedTuples, a step) equals the JAX function's
    result without a target and with a matching one (the target's
    containers back); a target of another shape raises naming the path."""
    import optax

    model = jtfm.build_transformer({**SMALL, "n_layers": 1})
    params = model.init(jax.random.PRNGKey(1), np.zeros((1, 8), np.int32))["params"]
    opt = optax.adam(1e-3)
    state = {"params": params, "opt_state": opt.init(params), "step": 5}
    path = str(tmp_path / "step_5")
    jckpt.save_checkpoint(path, state)
    _assert_same_tree(tckpt.restore_checkpoint(path), jckpt.restore_checkpoint(path))
    target = jax.tree.map(np.asarray, state)
    got, want = tckpt.restore_checkpoint(path, target), jckpt.restore_checkpoint(path, target)
    _assert_same_tree(got, want)
    assert type(got["opt_state"][0]).__name__ == "ScaleByAdamState"
    bad = jax.tree.map(np.asarray, {**state, "step": np.zeros(3)})
    with pytest.raises(ValueError, match="step_5"):
        tckpt.restore_checkpoint(path, bad)


# -- the committed fixture -------------------------------------------------------

def _leaf_records(params) -> list[dict]:
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


def test_fixture_is_what_the_jax_package_reads():
    """The JAX package's ``load_bundle`` of ``tests/data/orbax_lm/`` matches
    ``expected.json``'s hashes, the port's does too, and the JAX forward
    reproduces the committed logits (XLA's CPU code may order f32 sums by
    the host's vector width: 1e-5)."""
    expected = json.loads((FIXTURE / "expected.json").read_text())
    params, config = jckpt.load_bundle(str(FIXTURE))
    assert config == expected["config"]
    assert _leaf_records(params) == expected["leaves"]
    assert _leaf_records(tckpt.load_bundle(str(FIXTURE))[0]) == expected["leaves"]
    ids = np.asarray(expected["ids"], np.int32)
    logits = np.asarray(jtfm.build_transformer(config).apply({"params": params}, ids))
    np.testing.assert_allclose(logits, np.load(FIXTURE / expected["logits"]),
                               rtol=1e-5, atol=1e-5)
    size = sum(f.stat().st_size for f in FIXTURE.rglob("*") if f.is_file())
    assert size < 600_000


def test_chip_smoke_orbax_phase_runs_on_cpu(tmp_path):
    """``chip_smoke.phase_orbax_bundle`` shrunk onto the CPU, in a fresh
    process that imports the port only (the phase itself refuses to run
    with JAX, orbax, tensorstore or zstandard loaded)."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {str(REPO)!r})
        import chip_smoke as cs
        cs.WORK_DIR = {str(tmp_path)!r}
        cs.SEQ_LEN = 48
        cs.ORBAX_RATE_BYTES = 1 << 20
        out = cs.phase_orbax_bundle(0, "cpu", device="cpu")
        print(json.dumps(out))
    """)
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["launches"] == 0 and out["forward_launches"] == 0  # no kernel on the CPU
    assert out["logit_rel_err_vs_jax"] < 1e-4 and out["decode_mb_s"] > 0
    assert "[orbax] zstd decoder:" in run.stdout and "estimate, not measured" in run.stdout


# -- one check at the LM's full width ------------------------------------------

@pytest.mark.slow
def test_full_width_lm_bundle_bit_equal(tmp_path):
    """The LM at ``bench.py``'s width (vocab 32000, d_model 1024, 8 layers,
    8 heads; about 0.8 GB of f32 params) written by the JAX package in the
    orbax layout, read by the port's ``load_bundle`` leaf for leaf bit-equal
    to the JAX package's own ``load_bundle``."""
    import time

    cfg = {"model": "transformer", "vocab_size": 32000, "d_model": 1024, "n_layers": 8,
           "n_heads": 8, "bf16": False}
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: jtfm.build_transformer(cfg).init(
        jax.random.PRNGKey(0), np.zeros((1, 8), np.int32))["params"])
    params = jax.tree.map(lambda s: rng.standard_normal(s.shape, np.float32), shapes)
    export = tmp_path / "bundle"
    jckpt.save_checkpoint(str(export / "params"), params)
    (export / "bundle.json").write_text(json.dumps(cfg))
    del params
    t0 = time.perf_counter()
    got, _ = tckpt.load_bundle(str(export))
    port_s = time.perf_counter() - t0
    want, _ = jckpt.load_bundle(str(export))
    _assert_same_tree(got, want)
    nbytes = sum(a.nbytes for a in jax.tree.leaves(want))
    print(f"full-width bundle: {nbytes / 1e6:.1f} MB of params, the port's load_bundle "
          f"{port_s:.2f} s ({nbytes / 1e6 / port_s:.1f} MB/s, this host's CPU)")
