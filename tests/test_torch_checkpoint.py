"""The port's checkpoint files against the JAX package's on the CPU: the
same tree gives the same bytes (bf16 leaves, zamba's two stacked axes,
gemma's pairs, the MoE's experts and an optimizer state included), each
package loads the other's file bit for bit, ``params_to_numpy`` inverts
``params_from_numpy`` for every family, a missing key or a wrong shape
raises JAX's errors, and ``launch.train --ckpt`` writes a file JAX reads.
No msgpack is imported by the port: ``training/_msgpack.py`` is held to
the msgpack package here."""

import dataclasses
import io

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ASSIGNED as JAX_ASSIGNED
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.training import init_opt_state as jax_init_opt_state
from repro.training import load_checkpoint as jax_load_checkpoint
from repro.training import save_checkpoint as jax_save_checkpoint
from repro_torch.models import ModelConfig, init_params, params_from_numpy, params_to_numpy
from repro_torch.training import init_opt_state, load_checkpoint, save_checkpoint
from repro_torch.training import _msgpack

ARCHS = sorted(JAX_ASSIGNED) + ["paper-qwen1.5-0.5b"]


def _family(arch, bf16=False):
    jcfg = jax_get_config(arch).reduced()
    if bf16:
        jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    tree = jax.tree_util.tree_map(np.array, jax_init_params(jax.random.key(0), jcfg))
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg)), tree


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same_leaves(jax_tree, port_numpy_tree):
    assert (jax.tree_util.tree_structure(jax_tree)
            == jax.tree_util.tree_structure(port_numpy_tree))
    for a, b in zip(jax.tree_util.tree_leaves(jax_tree), jax.tree_util.tree_leaves(port_numpy_tree)):
        np.testing.assert_array_equal(_bits(a), b)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_numpy_inverts_params_from_numpy(arch):
    _, tcfg, tree = _family(arch)
    _same_leaves(tree, params_to_numpy(params_from_numpy(tree, tcfg, device="cpu"), tcfg))


@pytest.mark.parametrize("arch", ["paper-qwen1.5-0.5b", "zamba2-7b", "gemma2-27b",
                                  "granite-moe-3b-a800m"])
def test_file_is_byte_identical_to_jax_and_loads_both_ways(arch, tmp_path):
    """bf16 weights and an optimizer state of the same tree: the port's file
    equals JAX's byte for byte, and each package restores the other's bit
    for bit (the port into a tree of other values, like JAX)."""
    _, tcfg, tree = _family(arch, bf16=True)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    params = params_from_numpy(tree, tcfg, device="cpu")
    for name, jtree, ttree in (("params", jparams, params),
                               ("opt", jax_init_opt_state(jparams), init_opt_state(params))):
        jpath, tpath = tmp_path / f"jax_{name}.msgpack", tmp_path / f"port_{name}.msgpack"
        jax_save_checkpoint(str(jpath), jtree, step=17)
        save_checkpoint(str(tpath), ttree, step=17)
        assert tpath.read_bytes() == jpath.read_bytes(), name
        assert not (tmp_path / f"port_{name}.msgpack.tmp").exists()
    restored, step = jax_load_checkpoint(str(tmp_path / "port_params.msgpack"), jparams)
    assert step == 17
    _same_leaves(tree, jax.tree_util.tree_map(_bits, restored))
    fresh = params_from_numpy(jax.tree_util.tree_map(
        np.array, jax_init_params(jax.random.key(1), _family(arch, bf16=True)[0])), tcfg,
        device="cpu")
    loaded, step = load_checkpoint(str(tmp_path / "jax_params.msgpack"), fresh)
    assert step == 17
    assert ([t.dtype for t in jax.tree_util.tree_leaves(loaded)]
            == [t.dtype for t in jax.tree_util.tree_leaves(params)])
    assert torch.bfloat16 in {t.dtype for t in jax.tree_util.tree_leaves(loaded)}
    _same_leaves(tree, params_to_numpy(loaded, tcfg))


def test_missing_key_and_wrong_shape_raise_like_jax(tmp_path):
    path = str(tmp_path / "ck.msgpack")
    save_checkpoint(path, {"a": torch.ones(2), "b": {"c": torch.zeros(3, dtype=torch.int32)}},
                    step=3)
    tree, step = load_checkpoint(path, {"b": {"c": np.zeros(3)}})
    assert step == 3 and tree["b"]["c"].dtype == torch.int32
    with pytest.raises(KeyError, match="checkpoint missing b/d"):
        load_checkpoint(path, {"b": {"d": torch.ones(3)}})
    with pytest.raises(ValueError, match=r"a: shape \(2,\) != \(3,\)"):
        load_checkpoint(path, {"a": torch.ones(3)})
    for load, like in ((jax_load_checkpoint, {"b": {"d": jnp.ones(3)}}),
                       (jax_load_checkpoint, {"a": jnp.ones(3)})):
        with pytest.raises((KeyError, ValueError)):
            load(path, like)


def test_msgpack_subset_matches_msgpack():
    """``_msgpack.pack`` writes ``msgpack.packb(use_bin_type=True)``'s bytes
    and ``unpack`` reads them back, at every width boundary of ints, str,
    bin, arrays and maps; a bin payload over 4 GiB - 1 is refused."""
    objs = [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33,
            -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63, "", "a" * 31, "a" * 32,
            "é" * 200, "a" * 65536, b"", b"x" * 255, b"x" * 256, b"x" * 65536, [], list(range(15)),
            list(range(16)), list(range(65536)), {}, {str(i): i for i in range(15)},
            {str(i): [i] for i in range(16)}, None, True, False,
            {"step": 7, "arrays": {"g/0": {"dtype": "bfloat16", "shape": [2, 3],
                                           "data": b"\x01" * 12}}}]

    def plain(x):
        if isinstance(x, memoryview):
            return bytes(x)
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        if isinstance(x, list):
            return [plain(v) for v in x]
        return x

    for obj in objs:
        out = io.BytesIO()
        _msgpack.pack(obj, out.write)
        want = msgpack.packb(obj, use_bin_type=True)
        assert out.getvalue() == want, repr(obj)[:40]
        assert plain(_msgpack.unpack(want)) == msgpack.unpackb(want, raw=False)

    with pytest.raises(ValueError, match="too large"):     # the header of a 4 GiB leaf
        _msgpack._head(2**32, 0, 0, _msgpack._BIN)


def test_launcher_checkpoint_is_read_by_jax(tmp_path):
    """``python -m repro_torch.launch.train --device cpu --steps 3 --ckpt``
    writes the trained reduced model; JAX's ``load_checkpoint`` restores it
    into its own ``init_params`` tree, equal to the port's own load."""
    from repro_torch.launch import train

    path = str(tmp_path / "train.msgpack")
    train.main(["--arch", "qwen2-0.5b", "--steps", "3", "--batch", "2", "--seq", "32",
                "--device", "cpu", "--ckpt", path])
    jcfg, tcfg, tree = _family("qwen2-0.5b")
    restored, step = jax_load_checkpoint(path, jax.tree_util.tree_map(jnp.asarray, tree))
    assert step == 3
    loaded, _ = load_checkpoint(path, params_from_numpy(tree, tcfg, device="cpu"))
    _same_leaves(restored, params_to_numpy(loaded, tcfg))
    init = params_to_numpy(init_params(tcfg, seed=0, device="cpu"), tcfg)
    moved = [float(np.max(np.abs(np.asarray(a) - b))) for a, b in zip(
        jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(init))]
    assert min(moved) > 0                           # every leaf trained from the seed-0 init


def test_launcher_refuses_dry_run():
    """Without a GPU and without ``--device cpu``, ``--dry-run`` raises
    (the device rule) before it starts the dry-run."""
    from repro_torch.launch import train

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "qwen2-0.5b", "--dry-run"])
