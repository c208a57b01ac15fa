"""DisCEdge core — the paper's primary contribution.

Distributed context management for LLM serving at the edge: tokenized
context values, the Context Manager middleware, and the client-driven
turn-counter consistency protocol on top of the eventually consistent
distributed KV store (repro_torch.store).

The port's copy of ``repro.core``, with the same public names.
"""

from .protocol import (
    NODE_DOWN,
    OVERLOADED,
    ConsistencyPolicy,
    ContextMode,
    Request,
    Response,
    StaleContextError,
    Ticket,
    Timing,
    is_node_down_error,
    is_overload_error,
)
from .tokens import RawContext, TokenizedContext
from .session import ChatTurn, Session, context_key, fresh_session_id, fresh_user_id
from .consistency import (
    ReadResult,
    RetryPolicy,
    check_monotonic_reads,
    check_read_your_writes,
    read_with_turn_check,
    read_with_turn_check_async,
)
from .manager import (
    ContextManager,
    PreparedTurn,
    ServiceCapabilities,
    ServiceResult,
)

__all__ = [
    "NODE_DOWN",
    "OVERLOADED",
    "is_node_down_error",
    "is_overload_error",
    "ConsistencyPolicy",
    "ContextMode",
    "Request",
    "Response",
    "StaleContextError",
    "Ticket",
    "Timing",
    "RawContext",
    "TokenizedContext",
    "ChatTurn",
    "Session",
    "context_key",
    "fresh_session_id",
    "fresh_user_id",
    "ReadResult",
    "RetryPolicy",
    "check_monotonic_reads",
    "check_read_your_writes",
    "read_with_turn_check",
    "read_with_turn_check_async",
    "ContextManager",
    "PreparedTurn",
    "ServiceCapabilities",
    "ServiceResult",
]
