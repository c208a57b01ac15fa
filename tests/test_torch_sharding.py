"""The port's sharding specs and logical rules (``repro_torch.launch.
sharding``, ``repro_torch.models.pjit_rules``) against the JAX package's,
for all eleven configurations at full width: specs are metadata, so the
parameter trees are abstract (meta tensors in the port, ShapeDtypeStructs
in JAX) and nothing is allocated. Specs compare as tuples, leaf for leaf by
path. Then the JAX package's own sharding tests
(``tests/test_sharding_specs.py``, and ``test_fsdp_prefers_inner_dims`` of
``tests/test_perf_features.py``) run on the port, and the Mamba2 case where
the stacked layout decides a spec."""

import functools

import jax
import pytest
from jax.sharding import PartitionSpec as JaxP

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config
from repro.launch import sharding as jax_sharding
from repro.models import abstract_params as jax_abstract_params
from repro.models import pjit_rules as jax_rules
from repro_torch.configs import ALL, get_config
from repro_torch.launch import sharding
from repro_torch.launch.sharding import (
    _shard_first_free_dim,
    batch_specs,
    fsdp_param_specs,
    logits_spec,
    opt_state_specs,
    param_specs,
)
from repro_torch.models import abstract_params
from repro_torch.models.pjit_rules import (
    P,
    attention_weights_replicated,
    current_rules,
    rules_for,
    sharding_rules,
)
from repro_torch.models.weights import jax_layout, tree_leaves
from repro_torch.training import init_opt_state

MODEL = 16
ARCHS = sorted(ALL)
ASSIGNED = sorted(a for a in ALL if a != "paper-qwen1.5-0.5b")
MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})


def jax_flat(tree, is_leaf=None):
    """{path: leaf} of a JAX pytree; a path holds dict keys and sequence
    indices."""
    return {tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def port_flat(tree, path=()):
    """{path: leaf} of a port tree, paths as ``jax_flat``'s."""
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items() for p, x in port_flat(v, path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: x for i, v in enumerate(tree) for p, x in port_flat(v, path + (i,)).items()}
    return {path: tree}


def is_jax_spec(x):
    return isinstance(x, JaxP)


def assert_specs_equal(jax_tree, port_tree, where):
    want, got = jax_flat(jax_tree, is_jax_spec), port_flat(port_tree)
    assert want.keys() == got.keys(), (where, set(want) ^ set(got))
    for path, spec in want.items():
        assert isinstance(got[path], P), (where, path, got[path])
        assert tuple(got[path]) == tuple(spec), (where, path, got[path], spec)


@functools.lru_cache(maxsize=None)
def port_abstract(arch):
    return abstract_params(get_config(arch))


@functools.lru_cache(maxsize=None)
def jax_abstract(arch):
    return jax_abstract_params(jax_get_config(arch))


def jax_opt(arch):
    a = jax_abstract(arch)
    return {"m": a, "v": a, "step": jax.ShapeDtypeStruct((), jax.numpy.int32)}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_jax(arch):
    """param_specs, fsdp_param_specs and opt_state_specs (zero1 off and on)
    equal JAX's for every leaf, from the port's per-layer abstract tree."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    ta, ja = port_abstract(arch), jax_abstract(arch)
    assert_specs_equal(jax_sharding.param_specs(jcfg, ja, MODEL), param_specs(cfg, ta, MODEL),
                       "param_specs")
    assert_specs_equal(jax_sharding.fsdp_param_specs(jcfg, ja, MODEL),
                       fsdp_param_specs(cfg, ta, MODEL), "fsdp_param_specs")
    opt = init_opt_state(ta)
    for zero1 in (False, True):
        assert_specs_equal(jax_sharding.opt_state_specs(jcfg, jax_opt(arch), MODEL, zero1=zero1),
                           opt_state_specs(cfg, opt, MODEL, zero1=zero1), f"zero1={zero1}")


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_rules_match_jax(arch):
    """batch_specs and rules_for (three kinds x multi_pod), logits_spec and
    attention_weights_replicated equal JAX's."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for multi_pod in (False, True):
        for kind in ("train", "prefill", "decode"):
            want = jax_sharding.batch_specs(jcfg, multi_pod, kind)
            got = batch_specs(cfg, multi_pod, kind)
            assert want.keys() == got.keys()
            assert all(tuple(got[k]) == tuple(want[k]) for k in want), (kind, got, want)
            assert rules_for(cfg, multi_pod, MODEL, kind) == jax_rules.rules_for(
                jcfg, multi_pod, MODEL, kind)
        for batched in (True, False):
            assert tuple(logits_spec(cfg, multi_pod, batched)) == tuple(
                jax_sharding.logits_spec(jcfg, multi_pod, batched))
    assert attention_weights_replicated(cfg) == jax_rules.attention_weights_replicated(jcfg)


def test_partition_spec_canonical_as_jax():
    """Entries are canonical as JAX's: a 1-tuple of names is the name, an
    empty one None; specs compare with tuples and hash as values."""
    for parts in ((("data",), None), ((), "model"), (("pod", "data"), None, "model"), ()):
        assert tuple(P(*parts)) == tuple(JaxP(*parts))
        assert P(*parts) == tuple(JaxP(*parts))
    assert P(("data",), None) == ("data", None) == P("data", None)
    assert hash(P(("data",))) == hash(P("data"))
    assert len(P(None, "model")) == 2 and P(None, "model")[1] == "model"
    with pytest.raises(AttributeError):
        P("data")._parts = ()


def test_sharding_rules_context():
    """``sharding_rules`` binds a rule dict for its block and restores the
    one before it."""
    rules = rules_for(get_config("qwen2-0.5b"), multi_pod=False)
    assert current_rules() is None
    with sharding_rules(rules):
        assert current_rules() is rules
        with sharding_rules(None):
            assert current_rules() is None
        assert current_rules() is rules
    assert current_rules() is None


# ---------------------------------------------------------------------------
# tests/test_sharding_specs.py and test_perf_features.py, on the port
# ---------------------------------------------------------------------------

def _check_divisible(spec, shape, mesh, where=""):
    for axis_name, dim in zip(tuple(spec) + (None,) * (len(shape) - len(spec)), shape):
        if axis_name is None:
            continue
        names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
        total = 1
        for n in names:
            total *= mesh[n]
        assert dim % total == 0, f"{where}: dim {dim} not divisible by {total}"


@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_specs_complete_and_divisible(arch):
    cfg = get_config(arch)
    abs_p = jax_layout(port_abstract(arch), torch.stack)
    leaves_p = tree_leaves(abs_p)
    for specs in (param_specs(cfg, abs_p, MODEL), fsdp_param_specs(cfg, abs_p, MODEL)):
        leaves_s = tree_leaves(specs)
        assert len(leaves_p) == len(leaves_s)
        for leaf, spec in zip(leaves_p, leaves_s):
            assert isinstance(spec, P)
            assert len(spec) <= leaf.ndim
            for mesh in MESHES:
                _check_divisible(spec, leaf.shape, mesh, where=arch)


@pytest.mark.parametrize("arch", ["dbrx-132b", "nemotron-4-340b"])
def test_fsdp_never_shards_stack_dim(arch):
    cfg = get_config(arch)
    abs_p = port_flat(jax_layout(port_abstract(arch), torch.stack))
    specs = port_flat(fsdp_param_specs(cfg, port_abstract(arch), MODEL))
    for path, leaf in abs_p.items():
        if "groups" in path and leaf.ndim >= 3:
            spec = specs[path]
            parts = tuple(spec) + (None,) * (leaf.ndim - len(spec))
            assert parts[0] != "data", (path, spec)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_opt_specs_shard_more_than_params(arch):
    cfg = get_config(arch)
    ospecs = opt_state_specs(cfg, init_opt_state(port_abstract(arch)), MODEL, zero1=True)
    assert sum(1 for s in tree_leaves(ospecs["m"]) if "data" in str(s)) > 0  # ZeRO-1 bites
    assert ospecs["step"] == P()


def test_attention_replication_rule():
    assert attention_weights_replicated(get_config("qwen2-0.5b"))      # 14 heads
    assert attention_weights_replicated(get_config("qwen2-vl-7b"))     # 28
    assert not attention_weights_replicated(get_config("gemma2-27b"))  # 32
    assert not attention_weights_replicated(get_config("nemotron-4-340b"))  # 96


@pytest.mark.parametrize("arch", ASSIGNED)
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_rules_consistent(arch, kind):
    cfg = get_config(arch)
    rules = rules_for(cfg, multi_pod=True, kind=kind)
    assert rules["batch"] == ("pod", "data")
    if kind == "decode":
        assert rules["seq"] is None  # can't shard a length-1 query
    if cfg.n_heads and cfg.n_heads % 16 == 0:
        assert rules["heads"] == "model"


@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen2-vl-7b", "qwen2-0.5b"])
def test_batch_specs_shapes(arch):
    cfg = get_config(arch)
    bs = batch_specs(cfg, multi_pod=False, kind="train")
    assert "tokens" in bs and "labels" in bs
    if cfg.n_patches:
        assert "patch_embeds" in bs
    assert len(bs["tokens"]) == (3 if cfg.n_codebooks > 1 else 2)


def test_fsdp_prefers_inner_dims():
    """Layer-stacked params must not FSDP-shard dim 0 (the layer loop
    slices it)."""
    class A:  # minimal array stand-in
        def __init__(self, shape):
            self.shape = shape
            self.ndim = len(shape)

    assert _shard_first_free_dim(P(None, None, "model"), A((96, 18432, 4608))) == \
        P(None, "data", "model")
    # 1-D params still use dim 0
    assert _shard_first_free_dim(P(), A((1024,))) == P("data")


def test_mamba2_stack_axis_specs_need_the_stacked_layout():
    """Mamba2-1.3B is the one configuration whose FSDP / ZeRO-1 specs put
    ``data`` on a group leaf's stack axis (48 layers): five leaves, in the
    parameters and in the moments. Computed on a per-layer leaf, the same
    rule finds no free dim and leaves the spec alone; so the port computes
    its specs on the stacked layout, as JAX's."""
    arch = "mamba2-1.3b"
    cfg = get_config(arch)
    want = {"A_log": ("data", "model"), "D": ("data", "model"), "dt_bias": ("data", "model"),
            "conv_b": ("data", "model"), "conv_w": ("data", None, "model")}
    fsdp = port_flat(fsdp_param_specs(cfg, port_abstract(arch), MODEL))
    zero = port_flat(opt_state_specs(cfg, init_opt_state(port_abstract(arch)), MODEL,
                                     zero1=True)["m"])
    hits = {}
    for tree in (fsdp, zero):
        for path, spec in tree.items():
            if "groups" in path and tuple(spec)[:1] == ("data",):
                hits.setdefault(path[-1], []).append(tuple(spec))
    assert hits == {k: [v, v] for k, v in want.items()}, hits
    # per layer: the same rule on an un-stacked leaf
    layer = port_abstract(arch)["groups"][0][0]["ssm"]
    for name in want:
        base = sharding._pad(("model",) if name != "conv_w" else (None, "model"),
                             layer[name].ndim)
        assert "data" not in tuple(_shard_first_free_dim(base, layer[name])), name
    # the other ten configurations never do it
    for other in ARCHS:
        if other == arch:
            continue
        flat = port_flat(fsdp_param_specs(get_config(other), port_abstract(other), MODEL))
        assert not [p for p, s in flat.items() if "groups" in p and tuple(s)[:1] == ("data",)]
