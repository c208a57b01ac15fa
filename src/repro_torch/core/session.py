"""User sessions: the unit of context DisCEdge manages (paper §3) — the
port's copy of ``repro.core.session``."""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Tuple

_user_seq = itertools.count(1)
_session_seq = itertools.count(1)


def fresh_user_id() -> str:
    return f"user-{next(_user_seq):04d}"


def fresh_session_id() -> str:
    return f"sess-{next(_session_seq):04d}"


@dataclass
class ChatTurn:
    role: str
    content: str


@dataclass
class Session:
    user_id: str
    session_id: str
    model: str
    turns: List[ChatTurn] = field(default_factory=list)

    @property
    def turn_count(self) -> int:
        """Completed (user, assistant) exchanges."""
        return sum(1 for t in self.turns if t.role == "assistant")

    def history(self) -> List[Tuple[str, str]]:
        return [(t.role, t.content) for t in self.turns]

    def append(self, role: str, content: str) -> None:
        self.turns.append(ChatTurn(role, content))


def context_key(user_id: str, session_id: str) -> str:
    return f"{user_id}/{session_id}"
