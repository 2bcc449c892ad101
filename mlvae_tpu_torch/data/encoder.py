"""Label encoder with CTC blank handling.

The port's own copy of ``mlvae_tpu/data/encoder.py``'s ``LabelEncoder``
(SpeechBrain's ``CTCTextEncoder`` as the reference uses it): build from a
phoneme inventory, insert a blank, encode and decode sequences, and save
and load the same readable text file, so that a label file the JAX package
wrote loads here; ``get_label_encoder`` builds it from a recipe's hparams.
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterable, List, Sequence

import numpy as np


class LabelEncoder:
    BLANK = "<blank>"

    def __init__(self):
        self.lab2ind = {}
        self.ind2lab = {}

    def __len__(self):
        return len(self.lab2ind)

    # -- construction --------------------------------------------------------
    def update_from_iterable(self, labels: Iterable[str],
                             sequence_input: bool = False):
        if sequence_input:
            labels = [l for seq in labels for l in seq]
        for lab in labels:
            if lab not in self.lab2ind:
                idx = len(self.lab2ind)
                self.lab2ind[lab] = idx
                self.ind2lab[idx] = lab

    def insert_label(self, label: str, index: int):
        if label in self.lab2ind:
            raise ValueError(f"label already present: {label}")
        # list.insert position semantics: negative counts from the end,
        # out-of-range clamps — otherwise index=-1 would create an invalid
        # map (blank at key -1, colliding with the -1 padding sentinel)
        n = len(self.lab2ind)
        index = int(index)
        if index < 0:
            index = max(n + index, 0)
        index = min(index, n)
        # shift everything at >= index up by one
        new_lab2ind = {}
        for lab, ind in self.lab2ind.items():
            new_lab2ind[lab] = ind + 1 if ind >= index else ind
        new_lab2ind[label] = index
        self.lab2ind = new_lab2ind
        self.ind2lab = {i: l for l, i in new_lab2ind.items()}

    def insert_blank(self, index: int = 0):
        self.insert_label(self.BLANK, index)

    def get_blank_index(self) -> int:
        return self.lab2ind[self.BLANK]

    # -- encode / decode ------------------------------------------------------
    def encode_label(self, label: str) -> int:
        return self.lab2ind[label]

    def encode_sequence(self, seq: Sequence[str]) -> np.ndarray:
        return np.asarray([self.lab2ind[l] for l in seq], np.int64)

    def decode_ndim(self, ids):
        """Recursively decode arbitrarily nested (possibly ragged)
        sequences, preserving nesting — SpeechBrain decode_ndim contract
        (a flat reshape would crash on ragged batch input)."""
        if hasattr(ids, "ndim"):  # numpy array or torch tensor
            if ids.ndim == 0:
                return self.ind2lab[int(ids)]
            return [self.decode_ndim(x) for x in ids]
        if isinstance(ids, (list, tuple)):
            return [self.decode_ndim(x) for x in ids]
        return self.ind2lab[int(ids)]

    # -- persistence -----------------------------------------------------------
    def save(self, path):
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            for lab, ind in sorted(self.lab2ind.items(), key=lambda kv: kv[1]):
                f.write(f"'{lab}' => {ind}\n")

    @classmethod
    def load(cls, path) -> "LabelEncoder":
        enc = cls()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                lab, _, ind = line.rpartition(" => ")
                lab = lab.strip().strip("'")
                enc.lab2ind[lab] = int(ind)
        enc.ind2lab = {i: l for l, i in enc.lab2ind.items()}
        return enc


def get_label_encoder(hparams) -> LabelEncoder:
    """The dataset's label encoder: the phoneme set of
    ``hparams["prepare"]["phoneme_set_handler"]`` with the blank inserted
    at ``hparams["blank_index"]``."""
    enc = LabelEncoder()
    phoneme_set = hparams["prepare"]["phoneme_set_handler"].get_phoneme_set()
    enc.update_from_iterable(phoneme_set, sequence_input=False)
    enc.insert_blank(index=hparams["blank_index"])
    return enc
