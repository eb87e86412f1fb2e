"""ctypes wrappers over the native (C++) modality tokenizers — drop-in
replacements for data.tokenizers.NucleotideTokenizer / ProteinTokenizer
with identical outputs plus fast batch APIs for the input pipeline hot path
(one host core feeds the chips; the upstream project "native where the
reference's is").
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .. import native
from .tokenizers import NucleotideTokenizer, ProteinTokenizer


def native_available() -> bool:
    return native.available()


def _batch_call(fn_name: str, seqs: Sequence[str], max_length: int
                ) -> np.ndarray:
    import ctypes

    lib = native.load()
    enc = [s.encode("ascii", errors="replace") for s in seqs]
    offsets = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(b) for b in enc], out=offsets[1:])
    buf = b"".join(enc)
    out = np.empty((len(enc), max_length), np.int32)
    getattr(lib, fn_name)(
        buf, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        np.int32(len(enc)), np.int32(max_length),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


class NativeNucleotideTokenizer(NucleotideTokenizer):
    """Same vocabulary/ids as the Python tokenizer; encode runs in C++."""

    def encode(self, seq: str, max_length: int) -> np.ndarray:
        if not native.available():
            return super().encode(seq, max_length)
        return _batch_call("nt_encode_batch", [seq], max_length)[0]

    def encode_batch(self, seqs: Sequence[str],
                     max_length: int) -> np.ndarray:
        if not native.available():
            # zero-arg super() inside a comprehension raises on py<3.12
            enc = super().encode
            return np.stack([enc(s, max_length) for s in seqs])
        return _batch_call("nt_encode_batch", seqs, max_length)


class NativeProteinTokenizer(ProteinTokenizer):
    def encode(self, seq: str, max_length: int) -> np.ndarray:
        if not native.available():
            return super().encode(seq, max_length)
        return _batch_call("protein_encode_batch", [seq], max_length)[0]

    def encode_batch(self, seqs: Sequence[str],
                     max_length: int) -> np.ndarray:
        if not native.available():
            enc = super().encode
            return np.stack([enc(s, max_length) for s in seqs])
        return _batch_call("protein_encode_batch", seqs, max_length)
