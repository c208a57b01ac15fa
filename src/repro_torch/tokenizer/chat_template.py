"""ChatML-style chat templating — the port's copy of
``repro.tokenizer.chat_template`` (paper §2.1.1: chat models take role-tagged
multi-turn sequences). The Context Manager renders *only the new turn* through
this template in tokenized mode; raw mode re-renders and re-tokenizes the
whole history every request.
"""

from __future__ import annotations

from typing import Iterable, List

from .bpe import ByteLevelBPE, IM_END, IM_START, NL


def render_turn(role: str, content: str) -> str:
    return f"<|im_start|>{role}\n{content}<|im_end|>\n"


def render_conversation(turns: Iterable[tuple]) -> str:
    """turns: iterable of (role, content)."""
    return "".join(render_turn(r, c) for r, c in turns)


def encode_turn(tok: ByteLevelBPE, role: str, content: str) -> List[int]:
    """Tokenize one turn with explicit structural tokens (no re-tokenization of
    markers through BPE — they are first-class special ids)."""
    ids: List[int] = [IM_START]
    ids.extend(tok.encode(role))
    ids.append(NL)
    ids.extend(tok.encode(content))
    ids.append(IM_END)
    ids.append(NL)
    return ids


def encode_conversation(tok: ByteLevelBPE, turns: Iterable[tuple]) -> List[int]:
    ids: List[int] = []
    for role, content in turns:
        ids.extend(encode_turn(tok, role, content))
    return ids


ASSISTANT_PREFIX = [IM_START]


def assistant_header(tok: ByteLevelBPE) -> List[int]:
    """Generation header appended after the context: '<|im_start|>assistant\\n'."""
    ids: List[int] = [IM_START]
    ids.extend(tok.encode("assistant"))
    ids.append(NL)
    return ids
