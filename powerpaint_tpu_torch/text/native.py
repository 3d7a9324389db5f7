"""ctypes binding for the C++ CLIP BPE core of ``native/bpe_tokenizer.cpp``
(the port of ``powerpaint_tpu/text/native.py``).

``NativeBPETokenizer`` has the surface of ``text.tokenizer.ClipBPETokenizer``,
so ``TokenizerWrapper`` can sit on either; as in the JAX package it is not
the default tokenizer, and the Python BPE stays the oracle (the tests hold
the ids identical). Normalisation and word segmentation stay in Python
(``segment_words``); the per-word merge loop runs in C++. The library is
built from ``native/bpe_tokenizer.cpp`` into the port's ``_build/`` at
first use (``ops._build.load_native``); if it cannot be built, the
constructor raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
from typing import Dict, List, Sequence, Tuple

from powerpaint_tpu_torch.text.tokenizer import bytes_to_unicode, segment_words


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from powerpaint_tpu_torch.ops._build import load_native

    lib = load_native("bpe")
    lib.ppt_bpe_create.restype = ctypes.c_void_p
    lib.ppt_bpe_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
    ]
    lib.ppt_bpe_destroy.argtypes = [ctypes.c_void_p]
    lib.ppt_bpe_encode_words.restype = ctypes.c_int32
    lib.ppt_bpe_encode_words.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


class NativeBPETokenizer:
    """CLIP BPE backed by the C++ core; the surface of ClipBPETokenizer."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]]):
        lib = _lib()
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in vocab.items()}
        self.bos_id = vocab.get("<|startoftext|>", 49406)
        self.eos_id = vocab.get("<|endoftext|>", 49407)
        ordered = sorted(vocab.items(), key=lambda kv: kv[1])
        if [v for _, v in ordered] != list(range(len(ordered))):
            raise ValueError("vocab ids must be dense 0..N-1")
        vocab_blob = b"\x00".join(k.encode("utf-8") for k, _ in ordered) + b"\x00"
        merges_blob = b"\x00".join(
            f"{a} {b}".encode("utf-8") for a, b in merges) + b"\x00"
        self._handle = lib.ppt_bpe_create(
            vocab_blob, len(vocab_blob), len(ordered),
            merges_blob, len(merges_blob), len(merges),
            self.bos_id, self.eos_id)
        self._buf = (ctypes.c_int32 * 4096)()

    def __del__(self):
        if getattr(self, "_handle", None):
            _lib().ppt_bpe_destroy(self._handle)
            self._handle = None

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @classmethod
    def from_dir(cls, path: str) -> "NativeBPETokenizer":
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            for line in f.read().split("\n"):
                if not line or line.startswith("#version"):
                    continue
                parts = line.split()
                if len(parts) == 2:
                    merges.append((parts[0], parts[1]))
        return cls(vocab, merges)

    def encode_text(self, text: str) -> List[int]:
        words = segment_words(text)
        if not words:
            return []
        blob = b"\x00".join(w.encode("utf-8") for w in words) + b"\x00"
        n = _lib().ppt_bpe_encode_words(self._handle, blob, len(words),
                                        len(self._buf), self._buf)
        return list(self._buf[:n])

    def decode_ids(self, ids: Sequence[int]) -> str:
        byte_decoder = {v: k for k, v in bytes_to_unicode().items()}
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        buf = bytearray(byte_decoder[c] for c in text if c in byte_decoder)
        return buf.decode("utf-8", errors="replace").replace("</w>", " ").strip()
