"""Edge deployment — the port's copy of ``repro.edge``: the analytic
echo service, the edge node (Context Manager + LLM Service + replica), the
cluster wiring and the roaming client."""

from .cluster import CLIENT_DOWN_TAG, CLIENT_UP_TAG, EdgeCluster
from .client import CLIENT_HOST, LLMClient, SessionTrace
from .node import EdgeNode, LoadReport
from .service import EchoLLMService

__all__ = [
    "CLIENT_DOWN_TAG",
    "CLIENT_UP_TAG",
    "EdgeCluster",
    "CLIENT_HOST",
    "LLMClient",
    "SessionTrace",
    "EdgeNode",
    "LoadReport",
    "EchoLLMService",
]
