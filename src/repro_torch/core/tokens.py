"""Context value representations (paper §3: tokenized vs raw text).

The port's copy of ``repro.core.tokens``: the same names and behaviour,
on numpy and the standard library.

A session context is the sequence of chat turns. DisCEdge's design choice is
to persist and replicate it *pre-tokenized*; the raw-text baseline persists
the rendered text. Both are versioned with the turn counter — the version the
consistency protocol checks.

LLM context grows monotonically within a session (paper §2.2.2), which the
beyond-paper *delta replication* exploits: only the token suffix since the
peer's last acknowledged turn needs to ship.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..tokenizer.bpe import ByteLevelBPE


@dataclass
class TokenizedContext:
    """Session context as token ids, versioned by turn counter."""

    ids: List[int] = field(default_factory=list)
    turn: int = 0
    model: str = ""
    # offsets[i] = length of ids after turn i completed; enables delta slicing
    turn_offsets: List[int] = field(default_factory=list)

    def extend(self, new_ids: List[int]) -> None:
        self.ids.extend(new_ids)

    def commit_turn(self) -> None:
        self.turn += 1
        self.turn_offsets.append(len(self.ids))

    def delta_since(self, turn: int) -> List[int]:
        """Token suffix appended after `turn` (beyond-paper delta replication)."""
        if turn <= 0 or turn > len(self.turn_offsets):
            return list(self.ids)
        return self.ids[self.turn_offsets[turn - 1] :]

    def wire_bytes(self, tok: ByteLevelBPE) -> int:
        """Full-value replication payload size (paper Fig. 5 metric)."""
        return len(tok.serialize_tokens(self.ids)) + 32  # + key/version header

    def delta_wire_bytes(self, tok: ByteLevelBPE, since_turn: int) -> int:
        return len(tok.serialize_tokens(self.delta_since(since_turn))) + 32

    def serialize(self, tok: ByteLevelBPE) -> bytes:
        return tok.serialize_tokens(self.ids)

    def copy(self) -> "TokenizedContext":
        return TokenizedContext(
            ids=list(self.ids),
            turn=self.turn,
            model=self.model,
            turn_offsets=list(self.turn_offsets),
        )

    def __len__(self) -> int:
        return len(self.ids)


@dataclass
class RawContext:
    """Raw-text baseline: context persisted as rendered chat text."""

    text: str = ""
    turn: int = 0
    model: str = ""
    turn_offsets: List[int] = field(default_factory=list)  # char offsets

    def extend(self, more: str) -> None:
        self.text += more

    def commit_turn(self) -> None:
        self.turn += 1
        self.turn_offsets.append(len(self.text))

    def wire_bytes(self, tok: Optional[ByteLevelBPE] = None) -> int:
        return len(self.text.encode("utf-8")) + 32

    def copy(self) -> "RawContext":
        return RawContext(
            text=self.text,
            turn=self.turn,
            model=self.model,
            turn_offsets=list(self.turn_offsets),
        )

    def __len__(self) -> int:
        return len(self.text)
