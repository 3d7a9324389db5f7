"""CLIP tokenization with multi-vector task-prompt placeholders.

Counterpart of the reference ``TokenizerWrapper``
(reference ``powerpaint/utils/utils.py:15-254``), rebuilt without
transformers at runtime:

- ``ClipBPETokenizer``: the CLIP byte-pair-encoding algorithm, loading
  ``vocab.json`` + ``merges.txt`` from a checkpoint directory (the files ship
  with every SD1.5 checkpoint the reference loads, app.py:94).
- ``HashTokenizer``: a deterministic stand-in with the same id-space layout
  (bos/eos/pad = CLIP's 49406/49407/49407) for weight-free tests and
  benchmarks.
- ``TokenizerWrapper``: placeholder registration (``P_obj`` -> ``P_obj_0`` ..
  ``P_obj_9`` appended as NEW CONTIGUOUS ids at the end of the vocab), text
  expansion before encoding, and ``get_token_info`` returning the contiguous
  id range — identical contract to utils.py:118-254.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

try:  # the HF pattern needs \p{L}/\p{N}; `regex` ships with transformers
    import regex as _regex

    _HAVE_REGEX = True
except ImportError:  # pragma: no cover - regex is a baked-in dependency
    _regex = re
    _HAVE_REGEX = False

BOS_ID = 49406
EOS_ID = 49407
MAX_LEN = 77

def _clip_word_pattern():
    if _HAVE_REGEX:
        # byte-exact HF CLIPTokenizer pattern (tokenization_clip.py:318-321)
        return _regex.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
            r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
            _regex.IGNORECASE,
        )
    # stdlib-re approximation: \w ~ L+N+'_' so letters = [^\W\d_] misses
    # Nl/No digits and drops '_' entirely — only used if `regex` is absent.
    return re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[^\W\d_]+|\d|[^\s\w]+",
        re.IGNORECASE | re.UNICODE,
    )


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_cjk(cp: int) -> bool:
    # the BasicTokenizer CJK ranges (transformers tokenization_clip.py:215-236)
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def clip_normalize(text: str) -> str:
    """The exact text normalization the reference's tokenizer applies.

    Reference tokenization goes through transformers' slow ``CLIPTokenizer``;
    without ftfy installed that is ``BasicTokenizer(strip_accents=False,
    do_split_on_punc=False)`` (tokenization_clip.py:297-304,459-463):
    control-char strip / whitespace fold, CJK char isolation, NFC, whitespace
    split, per-token lowercase, single-space join."""
    out: List[str] = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if ch.isspace() or unicodedata.category(ch) == "Zs":
            out.append(" ")
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(t.lower() for t in text.split())


_PAT = _clip_word_pattern()


def segment_words(text: str) -> List[str]:
    """Normalize + split into CLIP word-regex chunks (HF-identical)."""
    return _PAT.findall(clip_normalize(text))


def bytes_to_unicode() -> Dict[int, str]:
    """CLIP/GPT-2 reversible byte->unicode map (public algorithm)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipBPETokenizer:
    """CLIP BPE (lowercase, word regex, byte-encode, merges, '</w>' suffix)."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]]):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.pat = _PAT
        # HF pre-seeds the cache so the special literals survive BPE intact
        self.cache: Dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.bos_id = self.encoder.get("<|startoftext|>", BOS_ID)
        self.eos_id = self.encoder.get("<|endoftext|>", EOS_ID)

    @classmethod
    def from_dir(cls, path: str) -> "ClipBPETokenizer":
        vocab_path = os.path.join(path, "vocab.json")
        merges_path = os.path.join(path, "merges.txt")
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_path, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = []
        for line in lines:
            if not line or line.startswith("#version"):
                continue
            parts = line.split()
            if len(parts) == 2:
                merges.append((parts[0], parts[1]))
        return cls(vocab, merges)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = set(zip(word[:-1], word[1:]))
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (
                    word[i] == first
                    and i < len(word) - 1
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = set(zip(word[:-1], word[1:]))
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in segment_words(text):
            token_b = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            for bpe_token in self._bpe(token_b).split(" "):
                # unknown -> unk token (HF maps to <|endoftext|>)
                ids.append(self.encoder.get(bpe_token, self.eos_id))
        return ids

    def decode_ids(self, ids: Sequence[int]) -> str:
        toks = [self.decoder.get(int(i), "") for i in ids]
        text = "".join(toks)
        buf = bytearray(
            self.byte_decoder[c] for c in text if c in self.byte_decoder
        )
        return buf.decode("utf-8", errors="replace").replace("</w>", " ").strip()


class HashTokenizer:
    """Deterministic word->id tokenizer with CLIP's id-space layout.

    Not BPE-faithful; exists so the full stack (placeholder expansion,
    contiguous external ids, pipelines, benchmarks) runs without checkpoint
    files.  Words hash into [1000, 49405]."""

    def __init__(self, vocab_size: int = 49408):
        self._vocab_size = vocab_size
        self.bos_id = vocab_size - 2
        self.eos_id = vocab_size - 1

    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    def encode_text(self, text: str) -> List[int]:
        words = _whitespace_clean(text).lower().split(" ")
        out = []
        for w in words:
            if not w:
                continue
            h = int.from_bytes(
                hashlib.sha1(w.encode("utf-8")).digest()[:4], "little"
            )
            out.append(1000 + h % (self._vocab_size - 1002))
        return out

    def decode_ids(self, ids: Sequence[int]) -> str:
        return " ".join(f"<{int(i)}>" for i in ids)


class TokenizerWrapper:
    """Placeholder-token management over a base tokenizer.

    Contract (matching reference utils.py):
    - ``add_placeholder_token('P_obj', num_vec_per_token=10)`` registers
      ``P_obj_0`` .. ``P_obj_9`` as new ids ``vocab_size + k`` (contiguous,
      in registration order across ALL placeholders);
    - ``__call__`` expands placeholders in text, then encodes with
      bos/eos/pad to ``max_length`` (CLIP pads with eos);
    - ``get_token_info`` returns the contiguous (start, end) id range.
    """

    def __init__(self, base, max_length: int = MAX_LEN):
        self.base = base
        self.max_length = max_length
        self.token_map: Dict[str, List[str]] = {}
        self._added: Dict[str, int] = {}  # added token -> id

    # -- registration -------------------------------------------------------

    @property
    def vocab_size(self) -> int:
        return self.base.vocab_size + len(self._added)

    @property
    def num_external_tokens(self) -> int:
        return len(self._added)

    def _add_token(self, tok: str) -> None:
        if tok in self._added:
            raise ValueError(f"token {tok!r} already added")
        self._added[tok] = self.base.vocab_size + len(self._added)

    def add_placeholder_token(
        self, placeholder: str, num_vec_per_token: int = 1
    ) -> None:
        for existing in self.token_map:
            if existing in placeholder or placeholder in existing:
                raise ValueError(
                    f"placeholder {placeholder!r} conflicts with {existing!r}"
                )
        if num_vec_per_token == 1:
            self._add_token(placeholder)
            self.token_map[placeholder] = [placeholder]
        else:
            names = [f"{placeholder}_{i}" for i in range(num_vec_per_token)]
            for n in names:
                self._add_token(n)
            self.token_map[placeholder] = names

    def get_token_info(self, placeholder: str) -> dict:
        names = self.token_map[placeholder]
        ids = [self._added[n] for n in names]
        assert ids == list(range(ids[0], ids[0] + len(ids)))
        return {"name": placeholder, "start": ids[0], "end": ids[-1] + 1}

    # -- encode/decode ------------------------------------------------------

    def expand_placeholders(self, text: str) -> str:
        for placeholder, names in self.token_map.items():
            if placeholder in text:
                text = text.replace(placeholder, " ".join(names))
        return text

    def _encode_word_or_added(self, text: str) -> List[int]:
        ids: List[int] = []
        for chunk in _whitespace_clean(text).split(" "):
            if chunk in self._added:
                ids.append(self._added[chunk])
            elif chunk:
                ids.extend(self.base.encode_text(chunk))
        return ids

    def __call__(
        self,
        text: Union[str, List[str]],
        *,
        max_length: Optional[int] = None,
        pad: bool = True,
    ) -> np.ndarray:
        """Returns int32 ids (B, max_length): bos + tokens + eos, eos-padded,
        truncated to max_length (CLIP semantics)."""
        if isinstance(text, str):
            text = [text]
        max_length = max_length or self.max_length
        rows = []
        for t in text:
            ids = self._encode_word_or_added(self.expand_placeholders(t))
            ids = ids[: max_length - 2]
            eos = getattr(self.base, "eos_id", EOS_ID)
            bos = getattr(self.base, "bos_id", BOS_ID)
            row = [bos] + ids + [eos]
            if pad:
                row = row + [eos] * (max_length - len(row))
            rows.append(row)
        return np.asarray(rows, dtype=np.int32)

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        inv = {v: k for k, v in self._added.items()}
        bos = getattr(self.base, "bos_id", BOS_ID)
        eos = getattr(self.base, "eos_id", EOS_ID)
        parts: List[str] = []
        pending: List[int] = []
        for i in ids:
            i = int(i)
            if skip_special and i in (bos, eos):
                continue
            if i in inv:
                if pending:
                    parts.append(self.base.decode_ids(pending))
                    pending = []
                parts.append(inv[i])
            else:
                pending.append(i)
        if pending:
            parts.append(self.base.decode_ids(pending))
        text = " ".join(p for p in parts if p)
        # collapse expanded placeholder sequences back (utils.py:172-194)
        for placeholder, names in self.token_map.items():
            text = text.replace(" ".join(names), placeholder)
        return text


def load_tokenizer(
    checkpoint_dir: Optional[str] = None, max_length: int = MAX_LEN
) -> TokenizerWrapper:
    """CLIP BPE if vocab files exist under checkpoint_dir, else hash fallback."""
    if checkpoint_dir:
        for sub in ("tokenizer", "."):
            d = os.path.join(checkpoint_dir, sub)
            if os.path.exists(os.path.join(d, "vocab.json")):
                return TokenizerWrapper(
                    ClipBPETokenizer.from_dir(d), max_length
                )
    return TokenizerWrapper(HashTokenizer(), max_length)


def add_task_tokens(
    tokenizer: TokenizerWrapper,
    placeholders: Sequence[str] = ("P_ctxt", "P_shape", "P_obj"),
    num_vectors_per_token: int = 10,
) -> int:
    """Register the PowerPaint task-prompt tokens (reference
    utils.py:486-530, app.py:102-108).  Returns total external rows."""
    for p in placeholders:
        tokenizer.add_placeholder_token(p, num_vec_per_token=num_vectors_per_token)
    return tokenizer.num_external_tokens
