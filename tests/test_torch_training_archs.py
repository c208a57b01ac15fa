"""``grads_fn`` of the port against JAX's on the CPU, f32, for each of the
ten assigned architectures' ``.reduced()`` configs and the paper model's:
the loss within 1e-5 relative and every gradient leaf (the port's through
``params_to_numpy``, in JAX's stacked layout) within 1e-4 of the JAX
leaf's max abs (measured on the CPU at 1.3e-6 to 7.9e-6, mamba2's the
largest; losses within 7.6e-8). Each case is the smallest batch that
runs its family's paths: 2 x 32 tokens (a multiple of the SSD chunk, 16,
for mamba2 and zamba2; past qwen2-vl's 16 patch rows), 2 x 96 for gemma2,
whose local layers' window (64) must cut in."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ASSIGNED as JAX_ASSIGNED
from repro.configs import get_config as jax_get_config
from repro.data import BatchIterator as JaxBatchIterator
from repro.models import init_params as jax_init_params
from repro.training.trainer import grads_fn as jax_grads_fn
from repro_torch.models import ModelConfig, params_from_numpy, params_to_numpy
from repro_torch.training import grads_fn

ARCHS = sorted(JAX_ASSIGNED) + ["paper-qwen1.5-0.5b"]
SEQ = {"gemma2-27b": 96}


def test_every_assigned_arch_is_covered():
    assert len(ARCHS) == 11


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax(arch):
    jcfg = jax_get_config(arch).reduced()
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tree = jax.tree_util.tree_map(np.array, jax_init_params(jax.random.key(0), jcfg))
    batch = next(JaxBatchIterator(jcfg, batch_size=2, seq_len=SEQ.get(arch, 32)))
    if jcfg.n_patches:
        batch["patch_embeds"] = np.random.default_rng(0).standard_normal(
            (2, jcfg.n_patches, jcfg.d_model)).astype(np.float32)
    jl, jm, jg = jax.jit(lambda p, b: jax_grads_fn(p, jcfg, b))(
        jax.tree_util.tree_map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tm, tg = grads_fn(params_from_numpy(tree, tcfg, device="cpu"), tcfg,
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-5, atol=1e-7)
    if jcfg.n_experts:
        assert float(jm["aux"]) > 0
    got = params_to_numpy(tg, tcfg)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(jg)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jg),
                            jax.tree_util.tree_leaves(got)):
        a = np.asarray(a)
        assert a.shape == b.shape, path
        scale = float(np.max(np.abs(a)))
        assert scale > 0, path                          # every leaf gets a gradient
        assert float(np.max(np.abs(a - b))) <= 1e-4 * scale, path
