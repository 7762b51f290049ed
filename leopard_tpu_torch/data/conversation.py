"""Conversation template library (port of leopard_tpu/data/conversation.py,
the same classes and templates, the same prompt strings).

A `Conversation` renders (role, message) turns into one flat prompt for
tokenizers without a chat template of their own: vicuna, llama-2, llama-3,
plain and mpt separators. Llama-3 training builds its ids at the token level
instead (data/chat.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from enum import Enum, auto
from typing import List, Optional, Tuple


class SeparatorStyle(Enum):
    SINGLE = auto()      # vicuna-style: "ROLE: msg SEP"
    TWO = auto()         # vicuna v1: alternating separators
    LLAMA_2 = auto()     # [INST] ... [/INST]
    LLAMA_3 = auto()     # <|start_header_id|>...<|eot_id|>
    PLAIN = auto()       # bare concatenation
    MPT = auto()         # <|im_start|>role\n...<|im_end|>


@dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[Tuple[str, Optional[str]]] = field(default_factory=list)
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append((role, message))

    def copy(self) -> "Conversation":
        return replace(self, messages=list(self.messages))

    def get_prompt(self) -> str:
        msgs = self.messages
        if self.sep_style == SeparatorStyle.SINGLE:
            out = self.system + self.sep
            for role, msg in msgs:
                out += f"{role}: {msg}{self.sep}" if msg else f"{role}:"
            return out
        if self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2 or self.sep]
            out = self.system + seps[0]
            for i, (role, msg) in enumerate(msgs):
                out += f"{role}: {msg}{seps[i % 2]}" if msg else f"{role}:"
            return out
        if self.sep_style == SeparatorStyle.LLAMA_2:
            out = ""
            for i, (role, msg) in enumerate(msgs):
                if msg is None:
                    continue
                if i % 2 == 0:
                    sys = f"<<SYS>>\n{self.system}\n<</SYS>>\n\n" if i == 0 and self.system else ""
                    out += f"<s>[INST] {sys}{msg} [/INST]"
                else:
                    out += f" {msg}</s>"
            return out
        if self.sep_style == SeparatorStyle.LLAMA_3:
            out = "<|begin_of_text|>"
            if self.system:
                out += f"<|start_header_id|>system<|end_header_id|>\n\n{self.system}<|eot_id|>"
            for role, msg in msgs:
                out += f"<|start_header_id|>{role}<|end_header_id|>\n\n"
                if msg is not None:
                    out += f"{msg}<|eot_id|>"
            return out
        if self.sep_style == SeparatorStyle.MPT:
            out = f"<|im_start|>system\n{self.system}<|im_end|>\n" if self.system else ""
            for role, msg in msgs:
                out += f"<|im_start|>{role}\n"
                if msg is not None:
                    out += f"{msg}<|im_end|>\n"
            return out
        # PLAIN
        return self.system + "".join(m or "" for _, m in msgs)


TEMPLATES = {
    "vicuna_v1": Conversation(
        system=(
            "A chat between a curious human and an artificial intelligence "
            "assistant. The assistant gives helpful, detailed, and polite "
            "answers to the human's questions."
        ),
        roles=("USER", "ASSISTANT"),
        sep_style=SeparatorStyle.TWO,
        sep=" ",
        sep2="</s>",
    ),
    "llama_2": Conversation(
        system=(
            "You are a helpful language and vision assistant. You are able to "
            "understand the visual content that the user provides, and assist "
            "the user with a variety of tasks using natural language."
        ),
        roles=("USER", "ASSISTANT"),
        sep_style=SeparatorStyle.LLAMA_2,
        sep="<s>",
        sep2="</s>",
    ),
    "llama_3": Conversation(
        system="",
        roles=("user", "assistant"),
        sep_style=SeparatorStyle.LLAMA_3,
        sep="",
    ),
    "plain": Conversation(
        system="",
        roles=("", ""),
        sep_style=SeparatorStyle.PLAIN,
        sep="\n",
    ),
    "mpt": Conversation(
        system="",
        roles=("user", "assistant"),
        sep_style=SeparatorStyle.MPT,
        sep="<|im_end|>",
    ),
}


def get_template(name: str) -> Conversation:
    return TEMPLATES[name].copy()
