"""Deterministic byte-level BPE tokenizer — the port's copy of
``repro.tokenizer.bpe``, kept byte-identical in behaviour: a PyTorch node
and a JAX node in one keygroup must tokenize identically.

DisCEdge's hot path is tokenization: the *raw* context mode re-tokenizes the
entire conversation history on every request, while the *tokenized* mode only
tokenizes the new prompt. To reproduce the paper's latency effect mechanically
(not with injected sleeps), this tokenizer is a real byte-level BPE whose
encode cost is proportional to input length.

Each model family gets its own tokenizer instance keyed by (vocab_size, seed)
— mirroring the paper's requirement that all LLM Services in a keygroup serve
the same model *and therefore the same tokenizer*.

The merge table is trained deterministically at first use from an embedded
corpus (word-frequency BPE, classic Sennrich algorithm), then cached
process-wide. The model's *embedding* vocab size can far exceed the number of
trained merges (real tokenizers ship ~100k merges; we train a bounded number
and reserve the rest of the id space — ids are what the model consumes, and
they stay < vocab_size).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Special tokens. Kept at the top of the id space layout, before byte tokens.
# ---------------------------------------------------------------------------
PAD, BOS, EOS, IM_START, IM_END, NL = 0, 1, 2, 3, 4, 5
N_SPECIAL = 8  # a couple reserved
_BYTE_BASE = N_SPECIAL  # byte b -> id N_SPECIAL + b
_FIRST_MERGE_ID = _BYTE_BASE + 256

SPECIAL_TOKENS = {
    PAD: "<|pad|>",
    BOS: "<|bos|>",
    EOS: "<|eos|>",
    IM_START: "<|im_start|>",
    IM_END: "<|im_end|>",
    NL: "\n",
}

# GPT-2-style pretokenizer, simplified: contractions, words, numbers, other.
_PRETOKEN_RE = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+"
)

# Embedded training corpus: the paper's 9-turn robotics scenario vocabulary
# plus a generic English/technical word pool. Deterministic.
_CORPUS_WORDS = """
the of and to in a is that for it as with on be are this by an robot robots
autonomous mobile sensor sensors obstacle avoidance lidar ultrasonic camera
infrared controller control motor proportional integral derivative error gain
function python code variable loop feedback setpoint localization mapping slam
simultaneous particle filter kalman extended state estimation odometry
challenges power compute memory latency bandwidth network edge node nodes
context token tokens tokenize tokenization session history turn counter user
client server storage store replication consistency distributed system systems
model models language large inference request response prompt chat message
what are most common types can you explain concept write simple how would
modify include now let talk about some main when implementing small low
compare approaches previous mentioned your kp represents component fundamental
components typical wheels chassis battery actuator actuators perception
planning navigation path grid map cell probability weight resample predict
update measurement noise covariance matrix linear nonlinear gaussian
""".split()


def _train_merges(n_merges: int, seed: int) -> List[Tuple[int, int]]:
    """Classic word-frequency BPE training over the embedded corpus.

    Deterministic for a given (n_merges, seed); the seed perturbs word
    frequencies so different model families get genuinely different merge
    tables (as in reality — tokenizers are model-dependent, paper §2.1.3).
    """
    rng = np.random.default_rng(seed)
    freqs: Dict[Tuple[int, ...], int] = {}
    for w in _CORPUS_WORDS:
        word = tuple(_BYTE_BASE + b for b in (" " + w).encode("utf-8"))
        freqs[word] = freqs.get(word, 0) + 1 + int(rng.integers(0, 50))

    merges: List[Tuple[int, int]] = []
    next_id = _FIRST_MERGE_ID
    for _ in range(n_merges):
        pair_counts: Dict[Tuple[int, int], int] = {}
        for word, f in freqs.items():
            for i in range(len(word) - 1):
                p = (word[i], word[i + 1])
                pair_counts[p] = pair_counts.get(p, 0) + f
        if not pair_counts:
            break
        # deterministic argmax: count desc, then pair asc
        best = min(pair_counts.items(), key=lambda kv: (-kv[1], kv[0]))[0]
        merges.append(best)
        new_freqs: Dict[Tuple[int, ...], int] = {}
        for word, f in freqs.items():
            out: List[int] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    out.append(next_id)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            t = tuple(out)
            new_freqs[t] = new_freqs.get(t, 0) + f
        freqs = new_freqs
        next_id += 1
    return merges


_TRAINED_CACHE: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}


@dataclass
class ByteLevelBPE:
    """Byte-level BPE tokenizer with a deterministic, seeded merge table.

    vocab_size is the *model* vocab (embedding rows); encoded ids are always
    < vocab_size. n_merges caps the trained merge count (min(1024, room)).
    """

    vocab_size: int
    seed: int = 0
    name: str = "bpe"
    n_merges: int = 1024
    _ranks: Dict[Tuple[int, int], int] = field(default_factory=dict, repr=False)
    _merge_id: Dict[Tuple[int, int], int] = field(default_factory=dict, repr=False)
    _decode_map: Dict[int, bytes] = field(default_factory=dict, repr=False)
    _word_cache: Dict[str, Tuple[int, ...]] = field(default_factory=dict, repr=False)

    def __post_init__(self) -> None:
        if self.vocab_size < _FIRST_MERGE_ID + 1:
            raise ValueError(
                f"vocab_size {self.vocab_size} too small; need > {_FIRST_MERGE_ID}"
            )
        room = self.vocab_size - _FIRST_MERGE_ID
        n = min(self.n_merges, room)
        key = (n, self.seed)
        if key not in _TRAINED_CACHE:
            _TRAINED_CACHE[key] = _train_merges(n, self.seed)
        merges = _TRAINED_CACHE[key]
        self._ranks = {pair: r for r, pair in enumerate(merges)}
        self._merge_id = {
            pair: _FIRST_MERGE_ID + r for r, pair in enumerate(merges)
        }
        # decode map: id -> bytes
        self._decode_map = {PAD: b"", BOS: b"", EOS: b"", IM_START: b"<|im_start|>",
                            IM_END: b"<|im_end|>", NL: b"\n", 6: b"", 7: b""}
        for b in range(256):
            self._decode_map[_BYTE_BASE + b] = bytes([b])
        for pair, mid in self._merge_id.items():
            self._decode_map[mid] = self._decode_map[pair[0]] + self._decode_map[pair[1]]

    # -- encoding -----------------------------------------------------------
    def _encode_word(self, word: str) -> Tuple[int, ...]:
        cached = self._word_cache.get(word)
        if cached is not None:
            return cached
        parts: List[int] = [_BYTE_BASE + b for b in word.encode("utf-8")]
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self._ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            parts[best_i : best_i + 2] = [
                self._merge_id[(parts[best_i], parts[best_i + 1])]
            ]
        out = tuple(parts)
        if len(self._word_cache) < 65536:
            self._word_cache[word] = out
        return out

    def encode(self, text: str, *, bos: bool = False, eos: bool = False) -> List[int]:
        ids: List[int] = [BOS] if bos else []
        for m in _PRETOKEN_RE.findall(text):
            ids.extend(self._encode_word(m))
        if eos:
            ids.append(EOS)
        return ids

    def decode(self, ids) -> str:
        buf = b"".join(self._decode_map.get(int(i), b"\xef\xbf\xbd") for i in ids)
        return buf.decode("utf-8", errors="replace")

    # -- serialization / byte accounting (DisCEdge sync-overhead metric) -----
    @property
    def token_nbytes(self) -> int:
        """Tight fixed-width packing: 2 bytes for vocab ≤ 64k, 3 bytes up to
        16.7M (covers every assigned vocab incl. 256000), else 4. The paper's
        −13..15 % sync reduction with a 152k vocab implies it, too, packs
        tokens tighter than int32 against ~4-char/token UTF-8 text."""
        if self.vocab_size <= 2 ** 16:
            return 2
        if self.vocab_size <= 2 ** 24:
            return 3
        return 4

    @property
    def token_dtype(self) -> np.dtype:
        return np.dtype(np.uint16) if self.token_nbytes == 2 else np.dtype(np.uint32)

    def serialize_tokens(self, ids) -> bytes:
        """Wire format of a tokenized context value (what the KV store ships)."""
        arr = np.asarray(ids, dtype=np.uint32)
        n = self.token_nbytes
        if n == 2:
            return arr.astype(np.uint16).tobytes()
        if n == 3:
            b4 = arr.astype("<u4").view(np.uint8).reshape(-1, 4)
            return b4[:, :3].tobytes()
        return arr.astype("<u4").tobytes()

    def deserialize_tokens(self, raw: bytes) -> List[int]:
        n = self.token_nbytes
        if n == 2:
            return np.frombuffer(raw, dtype=np.uint16).tolist()
        if n == 3:
            b3 = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            b4 = np.zeros((b3.shape[0], 4), np.uint8)
            b4[:, :3] = b3
            return b4.view("<u4").reshape(-1).tolist()
        return np.frombuffer(raw, dtype="<u4").tolist()

    def n_tokens(self, text: str) -> int:
        return len(self.encode(text))


_TOKENIZER_CACHE: Dict[Tuple[int, int], ByteLevelBPE] = {}


def get_tokenizer(vocab_size: int, seed: int = 0, name: str = "bpe") -> ByteLevelBPE:
    """Process-wide tokenizer registry (one per model family, paper §3.2)."""
    key = (vocab_size, seed)
    if key not in _TOKENIZER_CACHE:
        _TOKENIZER_CACHE[key] = ByteLevelBPE(vocab_size=vocab_size, seed=seed, name=name)
    return _TOKENIZER_CACHE[key]
