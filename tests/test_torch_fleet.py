"""The port's fleet layer (``repro_torch.fleet``: router, admission,
adaptive mounting, workload engine) against the JAX package's
``repro.fleet``.

Every scenario of ``tests/test_fleet.py`` runs through both packages with
each package's analytic ``EchoLLMService`` on every node, and every
observable must be equal: the routing decisions and rankings, the router's
reports and stale fallbacks, the heartbeats, the sheds, requeues and
failovers, the adaptive mounts' flips and concurrency EWMA, each
``Response`` field for field, and ``FleetResult.summary()``. As in
``tests/test_torch_discedge.py``, the wall-clock reads of the Context
Manager and the edge node are one fake ``perf_counter`` per package and the
session id counters restart at 1, so the timings are deterministic.

Beside them: ``generate_workload`` draws JAX's plans for the same specs,
``EdgeCluster.build(router=, admission_limit=)`` mounts the fleet, and an
``AdaptiveLLMService`` over the reduced paper model's single-stream and
batched services (the port's on CPU tensors, JAX's on its reference path)
serves the same greedy tokens on the same mount, turn for turn."""

import dataclasses
import importlib
import os
import sys
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_discedge import _package as _system_package  # noqa: E402


def _package(name, monkeypatch):
    """The package's system layers with deterministic clocks and ids
    (``tests/test_torch_discedge.py``), and its fleet layer."""
    pkg = _system_package(name, monkeypatch)
    pkg.fleet = importlib.import_module(f"{name}.fleet")
    return pkg


def _echo(pkg, n_slots=2, session_capacity=None, model="m", vocab=32000):
    return pkg.edge.EchoLLMService(model=model, vocab_size=vocab, kv_reuse=True,
                                   tokenize_scale=0.0, n_slots=n_slots,
                                   session_capacity=session_capacity)


def _fleet(pkg, n_nodes=3, n_slots=2, session_capacity=None, **build_kw):
    link = pkg.store.Link(latency_ms=1.0, bandwidth_mbps=1000.0)
    return pkg.edge.EdgeCluster.build(
        [f"n{i}" for i in range(n_nodes)],
        lambda nid: _echo(pkg, n_slots, session_capacity),
        inter_node_link=link, client_link=link, **build_kw)


def _report(pkg, nid, sent, received, resident=None, active=0, queue=0):
    return pkg.edge.LoadReport(node_id=nid, sent_at_ms=sent, resident=resident or {},
                               active=active, queue_depth=queue, received_at_ms=received)


def _resp(r):
    return dataclasses.asdict(r)


def _ticket(t):
    return (t.attempts, list(t.nodes_tried), t.latency_ms, t.completed_at_ms, _resp(t.response))


def _reports(router):
    return {k: dataclasses.asdict(v) for k, v in sorted(router.reports.items())}


def _nodes(cluster):
    return {nid: (n.alive, n.crashes, n.ewma_tps,
                  None if n.admission is None else (n.admission.admitted, n.admission.sheds))
            for nid, n in cluster.nodes.items()}


# -- the scenarios of tests/test_fleet.py, one function each -------------------

def s_policies(pkg):
    f = pkg.fleet
    p = f.ResidencyPolicy()
    reports = {"a": _report(pkg, "a", 0, 0, resident={"k": 500}, active=1),
               "b": _report(pkg, "b", 0, 0, active=0)}
    out = [p.choose(["a", "b"], "k", reports, 0.0)]
    reports["a"] = _report(pkg, "a", 0, 0, resident={"k": 500}, active=400, queue=398)
    out.append(p.choose(["a", "b"], "k", reports, 0.0))
    shed = f.ResidencyPolicy(shed_limit=4)
    out.append(shed.choose(["a", "b"], "k", {
        "a": _report(pkg, "a", 0, 0, resident={"k": 5000}, active=4),
        "b": _report(pkg, "b", 0, 0, active=1)}, 0.0))
    out.append([p.choose(["a", "b", "c"], None, {}, 0.0) for _ in range(5)])
    rr = f.RoundRobinPolicy()
    out.append([rr.choose(["a", "b"], None, {}, 0.0) for _ in range(4)])
    rnd = f.make_policy("random", seed=7)
    out.append([rnd.choose(list("abcde"), None, {}, 0.0) for _ in range(20)])
    out.append([f.make_policy(n, seed=3, shed_limit=2).name
                for n in ("random", "round_robin", "residency")])
    with pytest.raises(ValueError, match="unknown routing policy"):
        f.make_policy("nope")
    return out


def s_stale(pkg):
    cluster = _fleet(pkg, n_nodes=3)
    router = pkg.fleet.mount_router(cluster, pkg.fleet.RandomPolicy(seed=0), stale_after_ms=100.0)
    now = cluster.network.clock.now_ms
    router.observe(_report(pkg, "n0", now, now))
    router.observe(_report(pkg, "n1", now - 500, now - 500))
    out = [sorted(router.fresh_reports(["n0", "n1", "n2"])), router.route("m")]
    cluster.network.clock.advance(1_000.0)
    out += [router.route("m") for _ in range(6)]
    out += [router.route("m", exclude=["n0", "n2"]), router.route("m", exclude=["n0", "n1", "n2"])]
    return out + [router.stale_fallbacks, router.decisions, _reports(router)]


def s_reorder(pkg):
    cluster = _fleet(pkg, n_nodes=2)
    router = pkg.fleet.mount_router(cluster, pkg.fleet.RandomPolicy(seed=0))
    router.observe(_report(pkg, "n0", sent=50.0, received=60.0, active=9))
    router.observe(_report(pkg, "n0", sent=10.0, received=70.0, active=0))
    return _reports(router)


def s_heartbeats(pkg):
    cluster = _fleet(pkg, n_nodes=3, router="residency")
    client = pkg.edge.LLMClient(cluster, model="m")
    r = client.chat("hello fleet", None)
    cluster.run_until_quiet()
    router = cluster.router
    return dict(resp=_resp(r), pending=cluster.network.pending_events, sent=router.bus.sent,
                failed=router.bus.failed, reports=_reports(router),
                key=f"{client.user_id}/{client.session_id}", decisions=router.decisions,
                stale=router.stale_fallbacks, now=cluster.network.clock.now_ms)


def s_sticky(pkg):
    cluster = _fleet(pkg, n_nodes=4, router="residency", warm_start="off")
    client = pkg.edge.LLMClient(cluster, model="m")
    trace = client.run_session([(f"turn {t}", None) for t in range(4)], think_ms=600.0)
    cluster.run_until_quiet()
    return dict(done=trace.done, tickets=[_ticket(t) for t in trace.tickets],
                reports=_reports(cluster.router), decisions=cluster.router.decisions)


def s_admission(pkg):
    adm = pkg.fleet.AdmissionControl(limit=2)
    return [adm.admit(0), adm.admit(1), adm.admit(2), adm.admit(5), adm.admitted, adm.sheds]


def s_shed_requeue(pkg):
    cluster = _fleet(pkg, n_nodes=2, n_slots=1)
    cluster.node("n0").admission = pkg.fleet.AdmissionControl(limit=0)
    client = pkg.edge.LLMClient(cluster, model="m", failover_salt=0)
    ticket = client.submit("hello", "n0")
    cluster.run_until_quiet()
    return dict(ticket=_ticket(ticket), requeues=client.requeues, failovers=client.failovers,
                nodes=_nodes(cluster))


def s_all_shed(pkg):
    cluster = _fleet(pkg, n_nodes=2, admission_limit=0)
    client = pkg.edge.LLMClient(cluster, model="m", max_attempts=3)
    ticket = client.submit("hello", "n0")
    cluster.run_until_quiet()
    return dict(ticket=_ticket(ticket), requeues=client.requeues,
                overload=pkg.core.is_overload_error(ticket.response.error), nodes=_nodes(cluster))


def _adaptive(pkg, hi=3, lo=2.0):
    return pkg.fleet.AdaptiveLLMService(single=_echo(pkg, n_slots=1),
                                        batched=_echo(pkg, n_slots=8), hi=hi, lo=lo)


def s_adaptive_flips(pkg):
    cluster = pkg.edge.EdgeCluster.build(["n0"], lambda nid: _adaptive(pkg))
    svc = cluster.node("n0").service
    tickets = [pkg.edge.LLMClient(cluster, model="m").submit("burst turn", "n0")
               for _ in range(4)]
    cluster.run_until_quiet()
    out = [[_ticket(t) for t in tickets], (svc.mode, svc.flips, svc.ewma_concurrency)]
    quiet = pkg.edge.LLMClient(cluster, model="m")
    for _ in range(8):
        out.append((_resp(quiet.chat("quiet turn", "n0")), svc.mode, svc.flips,
                    svc.ewma_concurrency))
        quiet.think(300.0)
    return out


def s_adaptive_inflight(pkg):
    svc = _adaptive(pkg, hi=2, lo=1.0)
    cluster = pkg.edge.EdgeCluster.build(["n0"], lambda nid: svc)
    tickets = [pkg.edge.LLMClient(cluster, model="m").submit("t", "n0") for _ in range(3)]
    cluster.run_until_quiet()
    with pytest.raises(AssertionError):
        pkg.fleet.AdaptiveLLMService(single=_echo(pkg), batched=_echo(pkg, model="other"))
    return [[_ticket(t) for t in tickets], svc.mode, svc.flips, svc._inflight,
            svc.ewma_concurrency, dataclasses.asdict(svc.capabilities()),
            sorted(svc.resident_keys().items())]


def s_failover_spread(pkg):
    cluster = _fleet(pkg, n_nodes=3)
    a = pkg.edge.LLMClient(cluster, model="m")
    b = pkg.edge.LLMClient(cluster, model="m")
    first = [_resp(a.chat("a turn 1", "n0")), _resp(b.chat("b turn 1", "n0"))]
    cluster.converge()
    peers = [a._failover_targets("n0"), b._failover_targets("n0")]
    cluster.crash("n0")
    ta, tb = a.submit("a turn 2", "n0"), b.submit("b turn 2", "n0")
    cluster.run_until_quiet()
    return dict(first=first, peers=peers, second=[_ticket(ta), _ticket(tb)],
                failovers=(a.failovers, b.failovers), users=(a.user_id, b.user_id))


def _summary(res, cluster):
    return dict(summary=res.summary(),
                traces=[[_ticket(t) for t in tr.tickets] for tr in res.traces],
                nodes=_nodes(cluster), reports=_reports(cluster.router),
                bus=(cluster.router.bus.sent, cluster.router.bus.failed))


def s_churn(pkg, policy="residency"):
    cluster = _fleet(pkg, n_nodes=3, session_capacity=8, router=policy, admission_limit=6)
    plans = pkg.fleet.generate_workload(pkg.fleet.WorkloadSpec(
        n_clients=16, seed=5, arrival_rate_per_s=20.0, max_turns=6))
    res = pkg.fleet.run_fleet(cluster, plans, policy_name=policy,
                              churn=[pkg.fleet.ChurnEvent("n1", 800.0, 2500.0)])
    return _summary(res, cluster)


def s_churn_random(pkg):
    return s_churn(pkg, "random")


def s_churn_round_robin(pkg):
    return s_churn(pkg, "round_robin")


def s_overload(pkg):
    """A burst on two single-slot nodes at admission limit 2, one node
    crashed for good mid-run: sheds, requeues and failovers all happen."""
    cluster = _fleet(pkg, n_nodes=2, n_slots=1, router="residency", admission_limit=2)
    plans = pkg.fleet.generate_workload(pkg.fleet.WorkloadSpec(
        n_clients=12, seed=9, arrival_rate_per_s=60.0, max_turns=4, think_ms_mean=100.0))
    res = pkg.fleet.run_fleet(cluster, plans, churn=[pkg.fleet.ChurnEvent("n1", 400.0)],
                              max_attempts=3)
    return _summary(res, cluster)


SCENARIOS = {f.__name__[2:]: f for f in (
    s_policies, s_stale, s_reorder, s_heartbeats, s_sticky, s_admission, s_shed_requeue,
    s_all_shed, s_adaptive_flips, s_adaptive_inflight, s_failover_spread, s_churn,
    s_churn_random, s_churn_round_robin, s_overload)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fleet_scenario_matches_jax(name, monkeypatch):
    jax_run = SCENARIOS[name](_package("repro", monkeypatch))
    port_run = SCENARIOS[name](_package("repro_torch", monkeypatch))
    assert port_run == jax_run
    # and each scenario shows what tests/test_fleet.py asserts of it
    r = port_run
    if name == "policies":
        assert r[:3] == ["a", "b", "b"] and set(r[3][:3]) == {"a", "b", "c"}
        assert r[4] == ["a", "b", "a", "b"]
    elif name == "stale":
        assert r[0] == ["n0"] and r[1][0] == "n0" and r[-3] == 8
    elif name == "reorder":
        assert r["n0"]["active"] == 9
    elif name == "heartbeats":
        assert r["resp"]["error"] is None and r["pending"] == 0 and r["sent"] >= 3
        assert set(r["reports"]) == {"n0", "n1", "n2"}
        assert r["reports"][r["resp"]["served_by"]]["resident"].get(r["key"], 0) > 0
    elif name == "sticky":
        resps = [t[-1] for t in r["tickets"]]
        assert r["done"] and len({x["served_by"] for x in resps}) == 1
        assert all(x["timing"]["kv_cache_hit"] for x in resps[1:])
    elif name == "admission":
        assert r == [True, True, False, False, 2, 2]
    elif name == "shed_requeue":
        assert r["ticket"][1] == ["n0", "n1"] and r["requeues"] == 1 and r["failovers"] == 0
    elif name == "all_shed":
        assert r["overload"] and r["requeues"] == 2
    elif name == "adaptive_flips":
        assert r[1][:2] == ("batched", 1) and r[-1][1:3] == ("single", 2)
    elif name == "adaptive_inflight":
        assert r[1:4] == ["batched", 1, 0]
    elif name == "failover_spread":
        assert r["peers"][0][1:] != r["peers"][1][1:]
        assert r["second"][0][-1]["served_by"] != r["second"][1][-1]["served_by"]
    else:
        s = r["summary"]
        assert s["hung_tickets"] == 0 and s["ok_turns"] > 0 and s["heartbeat_bytes"] > 0
        if name == "overload":
            assert s["sheds"] > 0 and s["requeues"] > 0 and s["failovers"] > 0


@pytest.mark.parametrize("spec", [
    dict(n_clients=16, seed=5, arrival_rate_per_s=20.0, max_turns=6),
    dict(n_clients=64, seed=0),
    dict(n_clients=40, seed=42, pareto_alpha=1.1, zipf_s=1.6, n_families=20),
    dict(n_clients=8, seed=7, diurnal_amplitude=0.0, think_ms_mean=10.0),
])
def test_generate_workload_matches_jax(spec):
    """Seeded numpy draws in the same order: the same plans as JAX's."""
    from repro.fleet import WorkloadSpec as JaxSpec
    from repro.fleet import generate_workload as jax_generate
    from repro_torch.fleet import WorkloadSpec, generate_workload

    jplans = [dataclasses.asdict(p) for p in jax_generate(JaxSpec(**spec))]
    tplans = [dataclasses.asdict(p) for p in generate_workload(WorkloadSpec(**spec))]
    assert tplans == jplans and len(tplans) == spec["n_clients"]
    assert dataclasses.asdict(WorkloadSpec()) == dataclasses.asdict(JaxSpec())


def test_fleet_exports_every_name_of_jax():
    import repro.fleet as jfleet
    import repro_torch.fleet as tfleet

    assert sorted(tfleet.__all__) == sorted(jfleet.__all__)
    for name in tfleet.__all__:
        t, j = getattr(tfleet, name), getattr(jfleet, name)
        if isinstance(j, (int, float, str)):
            assert t == j, name
        else:
            assert t.__module__.startswith("repro_torch.fleet."), name
    from repro.fleet import admission as ja
    from repro_torch.fleet import admission as ta
    assert (ta.DEFAULT_HI, ta.DEFAULT_LO, ta.CONCURRENCY_ALPHA) == \
        (ja.DEFAULT_HI, ja.DEFAULT_LO, ja.CONCURRENCY_ALPHA)


@pytest.mark.parametrize("router", ["residency", "round_robin", "policy"])
def test_build_mounts_router_and_admission(router):
    """``EdgeCluster.build(router=..., admission_limit=...)`` mounts a
    ``FleetRouter`` (by name or policy instance) with its heartbeat bus and
    one ``AdmissionControl`` per node; ``submit(node_id=None)`` routes."""
    from repro_torch.edge import EchoLLMService, EdgeCluster, LLMClient
    from repro_torch.fleet import AdmissionControl, FleetRouter, HeartbeatBus, ResidencyPolicy

    arg = ResidencyPolicy(shed_limit=1) if router == "policy" else router
    cluster = EdgeCluster.build(["a", "b"], lambda nid: EchoLLMService(model="m"),
                                router=arg, admission_limit=2)
    assert isinstance(cluster.router, FleetRouter) and isinstance(cluster.router.bus, HeartbeatBus)
    assert cluster.router.policy.name == ("residency" if router == "policy" else router)
    if router == "residency":
        assert cluster.router.policy.shed_limit == 2
    for node in cluster.nodes.values():
        assert isinstance(node.admission, AdmissionControl) and node.admission.limit == 2
    t = LLMClient(cluster, model="m").submit("hello", None)
    cluster.run_until_quiet()
    assert t.done and t.response.error is None and cluster.router.decisions == 1
    plain = EdgeCluster.build(["a"], lambda nid: EchoLLMService(model="m"))
    assert plain.router is None and plain.node("a").admission is None
    with pytest.raises(ValueError, match="router"):
        LLMClient(plain, model="m").submit("hello", None)


# -- AdaptiveLLMService over the reduced paper model ----------------------------

MAX_LEN, PS, KV_PAGES = 512, 16, 96


def _record(svc, log):
    """Log which mount each submit goes to."""
    for name in ("single", "batched"):
        mount = getattr(svc, name)
        real = mount.submit

        def submit(*a, _real=real, _name=name, **k):
            log.append(_name)
            return _real(*a, **k)

        mount.submit = submit
    return svc


def _adaptive_run(pkg, make_single, make_batched):
    log = []
    svc = _record(pkg.fleet.AdaptiveLLMService(single=make_single(), batched=make_batched()),
                  log)
    cluster = pkg.edge.EdgeCluster.build(["n0"], lambda nid: svc)
    burst = [pkg.edge.LLMClient(cluster, model="m", max_new_tokens=6) for _ in range(4)]
    tickets = [c.submit(f"burst question {i} about robots", "n0") for i, c in enumerate(burst)]
    cluster.run_until_quiet()
    turns = [(t.response.error, t.response.text, t.response.timing.kv_cache_hit)
             for t in tickets]
    modes = [(svc.mode, svc.flips)]
    quiet = pkg.edge.LLMClient(cluster, model="m", max_new_tokens=6)
    for i in range(5):
        r = quiet.chat(f"quiet question {i}", "n0")
        turns.append((r.error, r.text, r.timing.kv_cache_hit))
        modes.append((svc.mode, svc.flips))
        quiet.think(300.0)
    return turns, log, modes


def test_adaptive_service_real_model_matches_jax():
    """One node whose service is an ``AdaptiveLLMService`` over a paged
    single-stream service and a paged batched service of the reduced paper
    model (bridged weights): a burst of four clients flips it to the
    batched mount at the third submit, a quiet single-file tail flips it
    back; the texts, the mount of every turn and the flips equal JAX's."""
    from repro.configs.paper_qwen15_0_5b import CONFIG as JAX_PAPER
    from repro.models import init_params as jax_init_params
    from repro.serving import BatchedLLMService as JaxBatched
    from repro.serving import JaxLLMService
    from repro_torch.models import ModelConfig, params_from_numpy
    from repro_torch.serving import BatchedLLMService, TorchLLMService

    jcfg = JAX_PAPER.reduced()
    jparams = jax_init_params(jax.random.key(0), jcfg)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg)).replace(attn_impl="cuda")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    kw = dict(max_len=MAX_LEN, page_size=PS, kv_pages=KV_PAGES)
    bkw = dict(n_slots=4, max_len=MAX_LEN, paged=True, page_size=PS, kv_pages=KV_PAGES)
    jpkg = types.SimpleNamespace(edge=importlib.import_module("repro.edge"),
                                 fleet=importlib.import_module("repro.fleet"))
    tpkg = types.SimpleNamespace(edge=importlib.import_module("repro_torch.edge"),
                                 fleet=importlib.import_module("repro_torch.fleet"))
    jrun = _adaptive_run(
        jpkg, lambda: JaxLLMService.create("m", jcfg, seed=0, **kw),
        lambda: JaxBatched.create("m", jcfg, seed=0, **bkw))
    trun = _adaptive_run(
        tpkg, lambda: TorchLLMService.create("m", tcfg, device="cpu", params=tparams, **kw),
        lambda: BatchedLLMService.create("m", tcfg, device="cpu", params=tparams, **bkw))
    assert trun == jrun
    turns, log, modes = trun
    assert all(t[0] is None for t in turns)
    assert log == ["single", "single", "batched", "batched"] + ["single"] * 5
    assert modes[0] == ("batched", 1) and modes[-1] == ("single", 2)
