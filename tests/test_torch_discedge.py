"""The port's DisCEdge system layers against the JAX package's, with each
package's analytic ``EchoLLMService`` on every node.

``repro_torch.{core,store,edge}`` are copies of ``repro.{core,store,edge}``
that import nothing of JAX; here the same scenarios run through both and
every observable must be equal:

- the paper's 9-turn roaming scenario (switches at turns 3/5/7) in each
  context mode, with full and delta replication: every field of every
  ``Response`` (timing included), the store's sync/ack traffic, the
  client's uplink bytes and request sizes;
- faults and consistency: a drop window and a partition window under the
  STRONG and AVAILABLE policies, and a crash and restart of ``tx2`` with
  and without losing its replica (stale errors, retries, failover,
  ``converged()``);
- KV-page shipping forced to ship, forced to recompute, and decided by the
  cost model: ``kv_ship_stats()`` and ``warm_starts()``;
- ``repro_torch.data.synthetic``: the same sessions and training batches.

Beside them: the fleet options of ``EdgeCluster.build`` mount the port's
fleet layer (``tests/test_torch_fleet.py`` holds it to JAX), and keygroup
members with different tokenizers are refused.

The wall-clock reads of the Context Manager (tokenization, the async
update) and of the edge node (warm start) are replaced in both packages by
one fake ``perf_counter`` each, which advances a fixed step per call, and
the id counters restart at 1: every timing is deterministic, and it equals
across packages only if both make the same reads in the same order."""

import dataclasses
import importlib
import itertools
import os
import sys
import types

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
from chip_smoke import DISCEDGE_NODES as NODES  # noqa: E402  (the paper's scenario)
from chip_smoke import DISCEDGE_PROMPTS as PROMPTS  # noqa: E402

MODEL = "paper-qwen-mini"
# the example's node profiles (examples/serve_mobile_client.py)
PROFILES = {
    "m2": dict(prefill_ms_per_token=0.25, decode_ms_per_token=45.0, tokenize_scale=3.0),
    "tx2": dict(prefill_ms_per_token=1.0, decode_ms_per_token=180.0, tokenize_scale=40.0),
}
STEP_S = 3.7e-4   # the fake clock's advance per perf_counter() call


def _package(name, monkeypatch):
    """The package's modules, with its clocks and id counters made
    deterministic."""
    mods = {m: importlib.import_module(f"{name}.{m}") for m in (
        "core", "core.manager", "core.session", "edge", "edge.node", "store")}
    tick = itertools.count()
    fake = lambda: next(tick) * STEP_S  # noqa: E731
    monkeypatch.setattr(mods["core.manager"], "time", types.SimpleNamespace(perf_counter=fake))
    monkeypatch.setattr(mods["edge.node"], "perf_counter", fake)
    monkeypatch.setattr(mods["core.session"], "_user_seq", itertools.count(1))
    monkeypatch.setattr(mods["core.session"], "_session_seq", itertools.count(1))
    return types.SimpleNamespace(core=mods["core"], edge=mods["edge"], store=mods["store"])


def _cluster(pkg, *, replication="full", kv_ship=False, force=None, kv_bytes=0.0):
    def factory(nid):
        return pkg.edge.EchoLLMService(
            model=MODEL, vocab_size=151936, kv_reuse=True,
            kv_bytes_per_token=kv_bytes, **PROFILES[nid])

    kw = dict(kv_ship=True, kv_ship_force=force) if kv_ship else {}
    return pkg.edge.EdgeCluster.build(
        ["m2", "tx2"], factory,
        inter_node_link=pkg.store.Link(latency_ms=2.0, bandwidth_mbps=100.0),
        client_link=pkg.store.Link(latency_ms=5.0, bandwidth_mbps=20.0),
        replication=replication, **kw)


def _response(resp):
    d = dataclasses.asdict(resp)
    d["response_time_ms"] = resp.timing.response_time_ms
    return d


def _observe(cluster, client, responses):
    store, net = cluster.store, cluster.network
    return {
        "responses": [_response(r) for r in responses],
        "sync_bytes": cluster.sync_bytes(),
        "sync_messages": store.sync_messages(),
        "ack_bytes": store.ack_bytes(),
        "ack_messages": store.ack_messages(),
        "client_bytes_up": cluster.client_bytes_up(),
        "request_bytes_log": list(client.request_bytes_log),
        "traffic": net.traffic_snapshot(),
        "dropped": (net.dropped_messages, net.failed_sends, store.outbox_retries,
                    store.dropped_stale_applies),
        "now_ms": net.clock.now_ms,
        "warm_starts": cluster.warm_starts(),
        "converged": cluster.converged(),
        "client": (client.turn, client.failovers, client.timeouts, client.late_responses),
    }


def _paper_scenario(pkg, mode, replication):
    cluster = _cluster(pkg, replication=replication)
    client = pkg.edge.LLMClient(cluster, model=MODEL, mode=pkg.core.ContextMode(mode),
                                max_new_tokens=16)
    responses = []
    for p, n in zip(PROMPTS, NODES):
        r = client.chat(p, n)
        assert r.error is None, r.error
        responses.append(r)
        client.think(1500)
    cluster.converge()
    return _observe(cluster, client, responses)


@pytest.mark.parametrize("replication", ["full", "delta"])
@pytest.mark.parametrize("mode", ["tokenized", "raw", "client_side"])
def test_paper_scenario_matches_jax(mode, replication, monkeypatch):
    jax_run = _paper_scenario(_package("repro", monkeypatch), mode, replication)
    port_run = _paper_scenario(_package("repro_torch", monkeypatch), mode, replication)
    assert port_run == jax_run
    rs = port_run["responses"]
    # the scenario is what it claims: nine answered turns, served where the
    # client roamed, each context longer than the last (edge-side modes)
    assert [r["served_by"] for r in rs] == NODES
    assert port_run["converged"] and port_run["client_bytes_up"] > 0
    if mode != "client_side":
        assert port_run["sync_bytes"] > 0
        assert all(r["timing"]["tokenize_ms"] > 0 for r in rs)
    if mode == "tokenized":
        ctx = [r["n_context_tokens"] for r in rs]
        assert ctx == sorted(ctx) and ctx[0] == 0 < ctx[1]
        assert [r["timing"]["migrated"] for r in rs] == [
            False, False, True, False, True, False, True, False, True]


def _fault_scenario(pkg, case):
    """Nine turns through faults: a drop window and a partition between the
    nodes (STRONG or AVAILABLE), or a crash of tx2 after turn 4 with a
    restart before turn 9 (its replica kept or lost)."""
    policy = "available" if case == "partition-available" else "strong"
    cluster = _cluster(pkg)
    client = pkg.edge.LLMClient(cluster, model=MODEL,
                                policy=pkg.core.ConsistencyPolicy(policy),
                                max_new_tokens=16, failover_salt=0)
    if case.startswith("partition"):
        # a lossy inter-node link while turns 1-2 replicate (~[0, 3000) sim
        # ms), a background loss on every async message, and a partition
        # that the roamed turns read behind: STRONG fails some of them
        # after its retries, AVAILABLE serves them stale
        cluster.install_faults(pkg.store.FaultPlan(
            drops=[pkg.store.DropWindow("m2", "tx2", 0.0, 3500.0, prob=0.6)],
            partitions=[pkg.store.PartitionWindow("m2", "tx2", 6000.0, 14500.0)],
            drop_prob=0.2, seed=7,
        ))
    tickets = []
    for i, (p, n) in enumerate(zip(PROMPTS, NODES)):
        if case.startswith("crash") and i == 4:
            cluster.crash("tx2", lose_replica=case == "crash-lose-replica")
        if case.startswith("crash") and i == 8:
            cluster.restart("tx2")
        t = client.submit(p, n)
        cluster.run_until(lambda: t.done)
        tickets.append(t)
        client.think(1500)
    cluster.converge()
    out = _observe(cluster, client, [t.response for t in tickets])
    out["tickets"] = [(t.attempts, t.nodes_tried, t.latency_ms) for t in tickets]
    out["outbox"] = cluster.store.outbox_size()
    out["live"] = cluster.live_nodes()
    out["digests"] = {n: cluster.store.replica_digest(n, MODEL) for n in ("m2", "tx2")}
    return out


FAULT_CASES = ["partition-strong", "partition-available", "crash-keep-replica",
               "crash-lose-replica"]


@pytest.mark.parametrize("case", FAULT_CASES)
def test_faults_and_consistency_match_jax(case, monkeypatch):
    jax_run = _fault_scenario(_package("repro", monkeypatch), case)
    port_run = _fault_scenario(_package("repro_torch", monkeypatch), case)
    assert port_run == jax_run
    rs = port_run["responses"]
    assert port_run["converged"]
    if case.startswith("partition"):
        assert port_run["dropped"][0] > 0 and port_run["dropped"][2] > 0
    if case == "partition-strong":
        # the roam into the partition fails explicitly after its retries
        assert any(r["error"] and "replica" in r["error"] for r in rs)
        assert any(r["timing"]["retries"] > 0 for r in rs)
    if case == "partition-available":
        assert all(r["error"] is None for r in rs)
        assert any(r["stale"] for r in rs)
    if case.startswith("crash"):
        # turns 7-8 were sent to the crashed tx2 and failed over to m2
        assert [r["served_by"] for r in rs[6:8]] == ["m2", "m2"]
        assert port_run["client"][1] == 2 and all(r["error"] is None for r in rs)


def _ship_scenario(pkg, force):
    cluster = _cluster(pkg, kv_ship=True, force=force, kv_bytes=4096.0)
    client = pkg.edge.LLMClient(cluster, model=MODEL, max_new_tokens=16)
    responses = []
    for p, n in zip(PROMPTS, NODES):
        r = client.chat(p, n)
        assert r.error is None, r.error
        responses.append(r)
        client.think(1500)
    cluster.converge()
    out = _observe(cluster, client, responses)
    out["kv_ship_stats"] = cluster.kv_ship_stats()
    out["node_warm_starts"] = {n: cluster.node(n).warm_starts for n in ("m2", "tx2")}
    return out


@pytest.mark.parametrize("force", ["ship", "recompute", None])
def test_kv_shipping_matches_jax(force, monkeypatch):
    jax_run = _ship_scenario(_package("repro", monkeypatch), force)
    port_run = _ship_scenario(_package("repro_torch", monkeypatch), force)
    assert port_run == jax_run
    stats = port_run["kv_ship_stats"]
    assert port_run["warm_starts"] > 0 and stats["node_fallbacks"] == 0
    sources = [r["timing"]["kv_warm_source"] for r in port_run["responses"]]
    if force == "ship":
        assert stats["installed"] > 0 and stats["fallbacks"] == 0
        assert sources[2] == "pages"
    if force == "recompute":
        assert stats["installed"] == 0 and sources[2] == "tokens"


@pytest.mark.parametrize("option", [{"router": "residency"}, {"admission_limit": 4}])
def test_fleet_options_raise_until_fleet_is_ported(option):
    """The fleet layer is ported now, so the cluster's fleet options no
    longer raise: each mounts what JAX's ``build`` mounts, and is not
    ignored."""
    from repro_torch.edge import EchoLLMService, EdgeCluster
    from repro_torch.fleet import AdmissionControl, FleetRouter

    cluster = EdgeCluster.build(["a"], lambda nid: EchoLLMService(model="m"), **option)
    if "router" in option:
        assert isinstance(cluster.router, FleetRouter)
        assert cluster.router.policy.name == option["router"]
    else:
        assert cluster.router is None
        assert isinstance(cluster.node("a").admission, AdmissionControl)
        assert cluster.node("a").admission.limit == option["admission_limit"]


def test_keygroup_members_must_share_a_tokenizer():
    """Replication bytes are billed with one member's tokenizer, so members
    that tokenize differently are refused, as in JAX."""
    from repro_torch.edge import EchoLLMService, EdgeCluster

    with pytest.raises(AssertionError, match="must share one"):
        EdgeCluster.build(["a", "b"], lambda nid: EchoLLMService(
            model="m", vocab_size=4096, tokenizer_seed=int(nid == "b")))


@pytest.mark.parametrize("n_codebooks", [0, 4])
def test_synthetic_data_matches_jax(n_codebooks):
    """``repro_torch.data.synthetic`` draws JAX's sessions, token stream and
    training batches (the codebook branch too) from the same seeds."""
    import dataclasses as dc

    import numpy as np

    from repro.configs.paper_qwen15_0_5b import CONFIG as JAX_PAPER
    from repro.data import synthetic as jsyn
    from repro_torch.data import synthetic as tsyn
    from repro_torch.models import ModelConfig

    jcfg = JAX_PAPER.reduced().replace(n_codebooks=n_codebooks)
    tcfg = ModelConfig(**dc.asdict(jcfg))
    assert tsyn.synthetic_session(np.random.default_rng(3), 5) == \
        jsyn.synthetic_session(np.random.default_rng(3), 5)
    jit = jsyn.BatchIterator(jcfg, batch_size=2, seq_len=24, seed=1)
    tit = tsyn.BatchIterator(tcfg, batch_size=2, seq_len=24, seed=1)
    for _ in range(3):
        jb, tb = next(jit), next(tit)
        assert jb.keys() == tb.keys()
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
