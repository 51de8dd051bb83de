"""Label schemes: decode network outputs into consensus sequence.

Counterpart of ``medaka_tpu/labels.py``, trimmed to what consensus
decoding uses: ``BaseLabelScheme``, ``HaploidLabelScheme`` with
``decode_consensus`` and ``_phred``, and ``from_dict``. Truth encoding,
the diploid and RLE schemes and the VCF decoders are not ported yet;
``from_dict`` refuses those schemes by name.
"""
from __future__ import annotations

import abc
import functools

import numpy as np

label_schemes = {}


def from_dict(d):
    """Instantiate a label scheme from a config dict."""
    cls = label_schemes.get(d["type"])
    if cls is None:
        raise NotImplementedError(
            "Label scheme {} is not ported to medaka_tpu_torch yet "
            "(ported: {}).".format(d["type"], ", ".join(label_schemes)))
    return cls(**d.get("kwargs", {}))


class _SchemeMeta(abc.ABCMeta):
    def __new__(mcls, name, bases, attrs):
        cls = super().__new__(mcls, name, bases, attrs)
        if name != "BaseLabelScheme":
            label_schemes[name] = cls
        return cls


class BaseLabelScheme(metaclass=_SchemeMeta):
    """Logic for network-output decoding."""

    symbols = "*ACGT"

    @property
    @abc.abstractmethod
    def n_elements(self):
        """Number of truth elements per position (~ploidy)."""

    @property
    @abc.abstractmethod
    def num_classes(self):
        """Size of the network output layer."""

    @property
    @abc.abstractmethod
    def _encoding(self):
        """dict: label tuple -> integer."""

    def to_dict(self):
        """Serialise the scheme."""
        return dict(type=type(self).__name__)

    @staticmethod
    def _phred(err, cap=70.0):
        """Error probability to phred score, capped."""
        floor = 10.0 ** (cap / -10.0)
        return np.minimum(cap, -10 * np.log10(np.clip(err, floor, 1)))

    @property
    @functools.lru_cache(1)
    def _decoding(self):
        """dict: integer -> label tuple."""
        return {idx: label for label, idx in self._encoding.items()}

    @property
    def _unitary_encoding(self):
        return {(s,): i for i, s in enumerate(self.symbols)}


class HaploidLabelScheme(BaseLabelScheme):
    """Single truth element per position; 5-class softmax output."""

    @property
    def n_elements(self):
        """Ploidy (1)."""
        return 1

    @property
    def num_classes(self):
        """Output classes (5)."""
        return len(self._decoding)

    @property
    @functools.lru_cache(1)
    def _encoding(self):
        return self._unitary_encoding

    def decode_consensus(self, sample, with_gaps=False, dtype=None,
                         with_qualities=False):
        """Argmax decoding of network output into sequence (+ quals)."""
        classes = sample.label_probs.argmax(-1)
        keep = (slice(None) if with_gaps
                else classes != self.symbols.index("*"))
        alphabet = np.frombuffer(
            "".join(self.symbols).encode(), dtype=np.uint8)
        chars = alphabet[classes[keep]]
        seq = (chars.tobytes().decode() if dtype is None
               else chars.view("S1").astype(dtype))
        if not with_qualities:
            return seq
        best_p = np.take_along_axis(
            sample.label_probs, classes[:, None], -1)[keep, 0]
        qstring = (
            self._phred(1 - best_p).astype("u1") + 33).tobytes().decode()
        return seq, qstring
