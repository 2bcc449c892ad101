"""Dynamic-item dataset: a dict of samples and lazily evaluated pipelines
(the port's own copy of ``mlvae_tpu/data/dataset.py``, SpeechBrain's
``DynamicItemDataset`` as the recipes use it): dynamic items declared with
takes/provides and resolved as a DAG per sample, ``filtered_sorted`` by a
key, ``set_output_keys`` selecting what ``__getitem__`` returns. Host-side:
everything it returns is numpy or plain Python.
"""
from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional, Sequence


class DynamicItem:
    def __init__(self, func: Callable, takes: Sequence[str],
                 provides: Sequence[str]):
        self.func = func
        self.takes = list(takes)
        self.provides = list(provides)


def takes(*keys):
    def deco(fn):
        fn.__takes__ = list(keys)
        return fn
    return deco


def provides(*keys):
    def deco(fn):
        fn.__provides__ = list(keys)
        return fn
    return deco


class DynamicItemDataset:
    def __init__(self, data: Dict[str, Dict[str, Any]],
                 dynamic_items: Optional[List[DynamicItem]] = None,
                 output_keys: Optional[Sequence[str]] = None):
        self.data = data
        self.ids = list(data.keys())
        self.dynamic_items: List[DynamicItem] = list(dynamic_items or [])
        self.output_keys = list(output_keys or [])

    @classmethod
    def from_json(cls, json_path) -> "DynamicItemDataset":
        with open(json_path) as f:
            data = json.load(f)
        return cls(data)

    def __len__(self):
        return len(self.ids)

    # -- pipeline registration -------------------------------------------------
    def add_dynamic_item(self, func: Callable, takes_keys=None,
                         provides_keys=None):
        if takes_keys is None:
            takes_keys = getattr(func, "__takes__", None)
        if provides_keys is None:
            provides_keys = getattr(func, "__provides__", None)
        if takes_keys is None or provides_keys is None:
            raise ValueError(
                "dynamic item needs takes/provides (decorators or args)"
            )
        self.dynamic_items.append(DynamicItem(func, takes_keys, provides_keys))

    def set_output_keys(self, keys: Sequence[str]):
        self.output_keys = list(keys)

    # -- resolution --------------------------------------------------------------
    def _compute(self, utt_id: str, key: str, cache: Dict[str, Any],
                 in_flight: set) -> Any:
        if key in cache:
            return cache[key]
        if key == "id":
            cache["id"] = utt_id
            return utt_id
        static = self.data[utt_id]
        if key in static:
            cache[key] = static[key]
            return static[key]
        for item in self.dynamic_items:
            if key in item.provides:
                if id(item) in in_flight:
                    raise ValueError(f"circular dynamic item for key {key}")
                in_flight.add(id(item))
                args = [self._compute(utt_id, k, cache, in_flight)
                        for k in item.takes]
                in_flight.discard(id(item))
                result = item.func(*args)
                if len(item.provides) == 1:
                    # single-provides pipelines may be generator-style too
                    # (SpeechBrain idiom: one `yield` per provided key)
                    if hasattr(result, "__next__"):
                        result = next(result)
                    cache[item.provides[0]] = result
                else:
                    # generator-style multi-output (reference pipelines yield)
                    if hasattr(result, "__next__"):
                        for k in item.provides:
                            cache[k] = next(result)
                    else:
                        for k, v in zip(item.provides, result):
                            cache[k] = v
                return cache[key]
        raise KeyError(f"no source for key {key!r} (utt {utt_id})")

    def compute_sample(self, utt_id: str,
                       keys: Optional[Sequence[str]] = None) -> Dict[str, Any]:
        keys = keys or self.output_keys
        cache: Dict[str, Any] = {}
        return {k: self._compute(utt_id, k, cache, set()) for k in keys}

    def __getitem__(self, index) -> Dict[str, Any]:
        if isinstance(index, str):
            utt_id = index
        else:
            utt_id = self.ids[index]
        return self.compute_sample(utt_id)

    def __iter__(self):
        for utt_id in self.ids:
            yield self.compute_sample(utt_id)

    # -- sorting / filtering --------------------------------------------------------
    def filtered_sorted(self, sort_key: Optional[str] = None,
                        reverse: bool = False,
                        key_test: Optional[Dict[str, Callable]] = None
                        ) -> "DynamicItemDataset":
        ids = list(self.ids)
        if key_test:
            def ok(utt_id):
                s = self.compute_sample(utt_id, list(key_test.keys()))
                return all(fn(s[k]) for k, fn in key_test.items())
            ids = [i for i in ids if ok(i)]
        if sort_key is not None:
            ids.sort(key=lambda i: self.compute_sample(i, [sort_key])[sort_key],
                     reverse=reverse)
        sub = DynamicItemDataset(
            {i: self.data[i] for i in ids}, self.dynamic_items,
            self.output_keys,
        )
        sub.ids = ids
        return sub


def add_dynamic_item(datasets: List[DynamicItemDataset], func,
                     takes_keys=None, provides_keys=None):
    for ds in datasets:
        ds.add_dynamic_item(func, takes_keys, provides_keys)


def set_output_keys(datasets: List[DynamicItemDataset], keys):
    for ds in datasets:
        ds.set_output_keys(keys)
