"""The port's DisCEdge system with a real model against the JAX package's:
``paper_qwen15_0_5b.reduced()`` with bridged weights, one service per
node, the paper's 9-turn roaming scenario (``chip_smoke.py``'s
``phase_discedge`` runs it at full width on the card):

- the port's ``EdgeCluster`` with a ``TorchLLMService`` on each node and
  JAX's with a ``JaxLLMService`` on each node give, turn for turn, the same
  texts, context and generated token counts, session hits, reused tokens
  and warm starts — and that reuse pattern is the one ``phase_discedge``
  holds the card to;
- with KV-page shipping forced to ship, the port's ``KVShipper`` installs
  pages (warm source "pages", no fallback); forced to recompute, it primes
  from tokens; both give JAX's texts;
- ``python -m repro_torch.launch.serve`` with ``jax`` and ``repro``
  blocked prints the node, turn and context columns and the final sync and
  uplink bytes of ``python -m repro.launch.serve``.

``max_len`` is 1024: JAX's paged engine faults once its decode table is
``max_len`` wide (fault R1 of the reference, ROADMAP Queue 3), and at 512
the ninth turn's ~480 tokens widen it to 512."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.paper_qwen15_0_5b import CONFIG as JAX_PAPER
from repro.core import ContextMode as JaxMode
from repro.edge import EdgeCluster as JaxCluster
from repro.edge import LLMClient as JaxClient
from repro.models import init_params as jax_init_params
from repro.serving import JaxLLMService
from repro.store import Link as JaxLink
from repro_torch.core import ContextMode
from repro_torch.edge import EdgeCluster, LLMClient
from repro_torch.models import ModelConfig, params_from_numpy
from repro_torch.serving import TorchLLMService
from repro_torch.store import Link

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the scenario and the card's expectations)

PS, KV_PAGES, MAX_LEN = 16, 96, 1024
FIELDS = ("kv_cache_hit", "kv_reused_tokens", "kv_warm_start", "kv_warm_source")


@pytest.fixture(scope="module")
def models():
    jcfg = JAX_PAPER.reduced()
    jparams = jax_init_params(jax.random.key(0), jcfg)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg)).replace(attn_impl="cuda")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, tcfg, tparams


def _roam(pkg, factory, ship=None):
    cluster_cls, client_cls, link, mode = pkg
    kw = dict(kv_ship=True, kv_ship_force=ship) if ship else {}
    cluster = cluster_cls.build(
        ["m2", "tx2"], factory,
        inter_node_link=link(latency_ms=2.0, bandwidth_mbps=100.0),
        client_link=link(latency_ms=5.0, bandwidth_mbps=20.0), **kw)
    client = client_cls(cluster, model="m", mode=mode.TOKENIZED,
                        max_new_tokens=chip_smoke.DISCEDGE_MAX_NEW)
    turns = []
    for prompt, node in zip(chip_smoke.DISCEDGE_PROMPTS, chip_smoke.DISCEDGE_NODES):
        r = client.chat(prompt, node)
        assert r.error is None, r.error
        turns.append((r.served_by, r.text, r.n_context_tokens, r.n_generated_tokens,
                      *(getattr(r.timing, f) for f in FIELDS)))
        client.think(chip_smoke.DISCEDGE_THINK_MS)
    cluster.converge()
    assert cluster.converged()
    return turns, cluster


def _torch_factory(tcfg, tparams, ship=False):
    def factory(nid):
        svc = TorchLLMService.create("m", tcfg, max_len=MAX_LEN, page_size=PS,
                                     kv_pages=KV_PAGES, device="cpu", params=tparams)
        if ship:
            svc.ship_prefill_ms_per_token = 0.5
        return svc
    return factory


PORT = (EdgeCluster, LLMClient, Link, ContextMode)


@pytest.fixture(scope="module")
def jax_turns(models):
    jcfg = models[0]
    turns, _ = _roam((JaxCluster, JaxClient, JaxLink, JaxMode), lambda nid: JaxLLMService.create(
        "m", jcfg, seed=0, max_len=MAX_LEN, page_size=PS, kv_pages=KV_PAGES))
    return turns


def test_roaming_scenario_matches_jax(models, jax_turns):
    _, tcfg, tparams = models
    got, cluster = _roam(PORT, _torch_factory(tcfg, tparams))
    assert got == jax_turns
    # JAX's pattern is the one phase_discedge holds the card to: every turn
    # after the first reuses its whole context, only turn 3 is a warm start
    warm = chip_smoke.DISCEDGE_WARM_TURN
    for i, (_, _, n_ctx, _, hit, reused, is_warm, source) in enumerate(got, start=1):
        assert hit == (i > 1) and reused == n_ctx, (i, hit, reused, n_ctx)
        assert (is_warm, source) == ((True, "tokens") if i == warm else (False, "none")), i
    assert cluster.warm_starts() == 9
    for node in cluster.nodes.values():
        assert node.service.engine.paged_fallbacks == 0


@pytest.mark.parametrize("ship", ["ship", "recompute"])
def test_kv_shipping_scenario_matches_jax(models, jax_turns, ship):
    _, tcfg, tparams = models
    got, cluster = _roam(PORT, _torch_factory(tcfg, tparams, ship=True), ship=ship)
    source = "pages" if ship == "ship" else "tokens"
    warm = chip_smoke.DISCEDGE_WARM_TURN - 1
    want = [t[:-1] + ((source,) if i == warm else t[-1:]) for i, t in enumerate(jax_turns)]
    assert got == want
    stats = cluster.kv_ship_stats()
    assert stats["fallbacks"] == 0 and stats["node_fallbacks"] == 0
    if ship == "ship":
        assert stats["installed"] > 0 and stats["installed_pages"] > 0
    else:
        assert stats["installed"] == 0 and stats["decide_recompute"] > 0


_BLOCKED_SERVE = textwrap.dedent(
    """
    import importlib.abc, runpy, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    sys.argv = ["serve"] + ARGS
    runpy.run_module("repro_torch.launch.serve", run_name="__main__")
    """
)


def _columns(stdout):
    lines = stdout.strip().splitlines()
    rows = [ln.split()[:3] for ln in lines[1:] if ln.strip() and not ln.startswith("sync=")]
    return rows, lines[-1]


def test_serve_launcher_matches_jax():
    args = ["--nodes", "2", "--turns", "4", "--roam"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    port = subprocess.run([sys.executable, "-c", f"ARGS = {args!r}\n" + _BLOCKED_SERVE],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    ref = subprocess.run([sys.executable, "-m", "repro.launch.serve", *args],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    (prow, plast), (rrow, rlast) = _columns(port.stdout), _columns(ref.stdout)
    assert len(prow) == 4 and [r[0] for r in prow] == ["edge-0", "edge-0", "edge-1", "edge-1"]
    assert prow == rrow
    assert plast.startswith("sync=") and plast == rlast


def test_serve_launcher_arch_serves_through_the_kernels(monkeypatch, capsys):
    """``--arch`` gives every node a service on the kernel route
    (``attn_impl="cuda"``, as ``phase_discedge`` serves on the card); with
    ``--device cpu`` the wrappers run their plain versions and the session
    still roams and answers every turn."""
    from repro_torch.launch import serve
    from repro_torch import serving

    made = []
    create = serving.TorchLLMService.create

    def recording_create(model, cfg, **kw):
        svc = create(model, cfg, **kw)
        made.append((cfg.attn_impl, svc.engine.device.type))
        return svc

    monkeypatch.setattr(serving.TorchLLMService, "create", staticmethod(recording_create))
    serve.main(["--arch", JAX_PAPER.name, "--device", "cpu", "--turns", "2", "--roam",
                "--nodes", "2"])
    assert made == [("cuda", "cpu")] * 2
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines[1:3]] == ["edge-0", "edge-0"]
    assert lines[-1].startswith("sync=")
