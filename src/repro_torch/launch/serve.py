"""Serving launcher: bring up a DisCEdge cluster and run a scripted session
against it — the port's copy of ``repro.launch.serve``, with the same
flags and one more, ``--device``.

    PYTHONPATH=src python -m repro_torch.launch.serve --nodes 3 --turns 6
    PYTHONPATH=src python -m repro_torch.launch.serve --mode raw --roam
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-qwen1.5-0.5b  # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-qwen1.5-0.5b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m  # on the card

Without ``--arch`` every node runs the analytic ``EchoLLMService`` (no
device work). With ``--arch`` every node gets its own ``TorchLLMService``
(its own session pool) over one shared copy of the ``.reduced()`` model's
weights, served through the port's kernels (``attn_impl="cuda"``), on
``--device`` (default ``cuda``; without a GPU that raises
unless ``--device cpu`` is given).
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--turns", type=int, default=6)
    ap.add_argument("--mode", default="tokenized",
                    choices=["tokenized", "raw", "client_side"])
    ap.add_argument("--roam", action="store_true",
                    help="switch nodes every other turn")
    ap.add_argument("--arch", default=None,
                    help="serve a reduced real model instead of the echo service")
    ap.add_argument("--replication", default="full", choices=["full", "delta"])
    ap.add_argument("--device", default="cuda",
                    help="device of the --arch model: cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np

    from ..core import ContextMode
    from ..data.synthetic import synthetic_session
    from ..edge import EchoLLMService, EdgeCluster, LLMClient
    from ..store import Link

    if args.arch:
        from ..configs import get_config
        from ..device import resolve_device
        from ..models import init_params
        from ..serving import TorchLLMService

        # the Hopper kernels; on CPU tensors each wrapper runs its plain version
        cfg = get_config(args.arch).reduced().replace(attn_impl="cuda")
        device = resolve_device(args.device)
        params = init_params(cfg, seed=0, device=device)
        factory = lambda nid: TorchLLMService.create(  # noqa: E731
            cfg.name, cfg, max_len=2048, device=device, params=params)
        model = cfg.name
    else:
        model = "echo-qwen"
        factory = lambda nid: EchoLLMService(model=model)  # noqa: E731

    node_ids = [f"edge-{i}" for i in range(args.nodes)]
    cluster = EdgeCluster.build(
        node_ids, factory,
        inter_node_link=Link(latency_ms=3.0, bandwidth_mbps=100.0),
        client_link=Link(latency_ms=8.0, bandwidth_mbps=20.0),
        replication=args.replication,
    )
    client = LLMClient(cluster, model=model, mode=ContextMode(args.mode),
                       max_new_tokens=16)

    rng = np.random.default_rng(0)
    turns = synthetic_session(rng, n_turns=args.turns)
    prompts = [c for r, c in turns if r == "user"][: args.turns]
    print(f"{'node':8s} {'turn':4s} {'ctx':5s} {'rt_ms':8s}")
    for i, p in enumerate(prompts):
        node = node_ids[(i // 2) % len(node_ids)] if args.roam else node_ids[0]
        r = client.chat(p, node)
        assert r.error is None, r.error
        print(f"{node:8s} {r.turn:<4d} {r.n_context_tokens:<5d} "
              f"{r.timing.response_time_ms:<8.1f}")
        client.think(400)
    cluster.converge()
    print(f"\nsync={cluster.sync_bytes()}B uplink={sum(client.request_bytes_log)}B")


if __name__ == "__main__":
    main()
