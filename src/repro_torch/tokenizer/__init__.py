from .bpe import ByteLevelBPE, get_tokenizer, PAD, BOS, EOS, IM_START, IM_END, NL
from .chat_template import (
    assistant_header,
    encode_conversation,
    encode_turn,
    render_conversation,
    render_turn,
)

__all__ = [
    "ByteLevelBPE",
    "get_tokenizer",
    "PAD",
    "BOS",
    "EOS",
    "IM_START",
    "IM_END",
    "NL",
    "assistant_header",
    "encode_conversation",
    "encode_turn",
    "render_conversation",
    "render_turn",
]
