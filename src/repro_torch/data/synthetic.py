"""Synthetic data pipeline.

The port's copy of ``repro.data.synthetic``: the same names and behaviour,
plain numpy on the port's ``models.config`` and ``tokenizer``.

Two generators:
- chat-session corpus (for DisCEdge serving benchmarks and LM training) —
  seeded sentences over the paper's robotics vocabulary, rendered through
  the chat template, tokenized with the model's tokenizer;
- token-batch iterator for training: packs token streams into
  (batch, seq_len) next-token-prediction batches with a host-side
  prefetch-style buffer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

import numpy as np

from ..models.config import ModelConfig
from ..tokenizer import ByteLevelBPE, encode_conversation, get_tokenizer

_TOPICS = [
    "sensors for obstacle avoidance", "PID controller tuning",
    "SLAM on low power hardware", "particle filter localization",
    "path planning on a grid map", "battery and power management",
    "edge inference latency", "context tokenization overhead",
    "distributed storage consistency", "network bandwidth limits",
]
_LEADS = [
    "What are the fundamental components of", "How would you implement",
    "Can you explain the concept of", "What are the main challenges when using",
    "Compare the approaches for", "Write a simple function for",
]
_WORDS = (
    "robot sensor control state filter map path power node token context "
    "session model edge latency bandwidth storage consistency replica turn "
    "counter planner wheel motor camera lidar battery compute memory network"
).split()


def synthetic_sentence(rng: np.random.Generator, n_words: int = 12) -> str:
    return " ".join(rng.choice(_WORDS, size=n_words))


def synthetic_session(
    rng: np.random.Generator, n_turns: int = 6
) -> List[Tuple[str, str]]:
    turns: List[Tuple[str, str]] = []
    for _ in range(n_turns):
        q = f"{rng.choice(_LEADS)} {rng.choice(_TOPICS)}?"
        a = synthetic_sentence(rng, int(rng.integers(8, 24)))
        turns.append(("user", q))
        turns.append(("assistant", a))
    return turns


def token_stream(
    tok: ByteLevelBPE, seed: int = 0, session_turns: int = 6
) -> Iterator[int]:
    rng = np.random.default_rng(seed)
    while True:
        for t in encode_conversation(tok, synthetic_session(rng, session_turns)):
            yield t


@dataclass
class BatchIterator:
    """Packs a token stream into next-token training batches."""

    cfg: ModelConfig
    batch_size: int
    seq_len: int
    seed: int = 0
    tokenizer_seed: int = 0

    def __post_init__(self) -> None:
        self.tok = get_tokenizer(
            max(512, min(self.cfg.vocab_size, 65536)), seed=self.tokenizer_seed
        )
        self._stream = token_stream(self.tok, seed=self.seed)

    def __iter__(self) -> "BatchIterator":
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        n = self.batch_size * (self.seq_len + 1)
        flat = np.fromiter(self._stream, np.int32, count=n)
        flat = flat % self.cfg.vocab_size
        arr = flat.reshape(self.batch_size, self.seq_len + 1)
        batch = {
            "tokens": arr[:, :-1].copy(),
            "labels": arr[:, 1:].copy(),
        }
        if self.cfg.n_codebooks > 1:
            # audio: K parallel EnCodec-like codebook streams (stub frontend);
            # delay pattern = per-codebook shift of the same base stream
            k = self.cfg.n_codebooks
            base = arr[:, : self.seq_len + k]
            need = self.seq_len + k + 1 - base.shape[1]
            if need > 0:
                extra = np.fromiter(self._stream, np.int32, count=self.batch_size * need)
                base = np.concatenate(
                    [base, extra.reshape(self.batch_size, need) % self.cfg.vocab_size],
                    axis=1,
                )
            toks = np.stack(
                [base[:, i : i + self.seq_len] for i in range(k)], axis=-1
            )
            labels = np.stack(
                [base[:, i + 1 : i + 1 + self.seq_len] for i in range(k)], axis=-1
            )
            batch = {"tokens": toks, "labels": labels}
        return batch
