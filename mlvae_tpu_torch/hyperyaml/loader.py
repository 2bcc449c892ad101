"""HyperPyYAML-dialect config loader (the port's own copy of
``mlvae_tpu/hyperyaml/loader.py``).

The recipes are written in SpeechBrain's HyperPyYAML dialect:
``!new:``/``!name:``/``!module:``/``!apply:`` construction, ``!ref`` and
``!copy`` references with arithmetic and string interpolation,
``!include:`` composition whose mapping children act as overrides,
``!PLACEHOLDER`` required keys, implicit ``(a, b)`` tuples and nested
override merging. The YAML is parsed once into a tagged tree
(:class:`TaggedValue` keeps each node's tag); overrides are merged,
references resolved and includes spliced as tree transforms; then the
tree is materialized, each shared ``!ref`` target exactly once.

Dotted names resolve through :mod:`mlvae_tpu_torch.hyperyaml.registry`,
onto the port's classes. A recipe names neither a device nor a random
generator, while every module of the port takes both: ``load_hyperyaml``
passes its ``device`` and ``generator`` to every port callable whose
signature has those parameters and whose YAML node does not set them, so
modules are built on the run's device with weights drawn from the run's
generator (which ``!apply:torch.manual_seed`` seeds). ``device=None``
means CUDA, as everywhere in the port.
"""
from __future__ import annotations

import ast
import copy
import functools
import inspect
import operator as op
import os.path
import re
import warnings
from io import StringIO
from typing import Any, Dict, List, Optional

import yaml

from mlvae_tpu_torch.hyperyaml.registry import locate


# ---------------------------------------------------------------------------
# Tagged tree parsing
# ---------------------------------------------------------------------------

class TaggedValue:
    """A YAML node that carried a local (``!...``) tag."""

    __slots__ = ("tag", "value")

    def __init__(self, tag: str, value: Any):
        self.tag = tag
        self.value = value

    def __repr__(self):
        return f"TaggedValue({self.tag!r}, {self.value!r})"

    def __deepcopy__(self, memo):
        return TaggedValue(self.tag, copy.deepcopy(self.value, memo))


class Placeholder:
    """Dumpable stand-in for ``!PLACEHOLDER`` (``dump_hyperyaml``)."""

    yaml_tag = "!PLACEHOLDER"


class RefTag:
    """Dumpable stand-in for ``!ref <key>`` (``dump_hyperyaml``)."""

    yaml_tag = "!ref"

    def __init__(self, ref_str: str):
        self.ref_str = ref_str


class _TaggedLoader(yaml.SafeLoader):
    pass


def _tagged_constructor(loader: _TaggedLoader, tag_suffix: str, node):
    tag = node.tag
    if isinstance(node, yaml.MappingNode):
        value: Any = loader.construct_mapping(node, deep=True)
    elif isinstance(node, yaml.SequenceNode):
        value = loader.construct_sequence(node, deep=True)
    else:
        value = loader.construct_scalar(node)
    return TaggedValue(tag, value)


_TaggedLoader.add_multi_constructor("!", _tagged_constructor)


def _str_constructor(loader: _TaggedLoader, node):
    """Tuple conversion happens HERE, on PLAIN scalars only — reference
    parity: HyperPyYAML registers ``(...)`` as an implicit !tuple resolver,
    so quoting is the escape hatch (``pattern: "(.*)"`` stays a string)."""
    value = loader.construct_scalar(node)
    if node.style is None and _TUPLE_RE.match(value):
        return _maybe_tuple(value)
    return value


_TaggedLoader.add_constructor("tag:yaml.org,2002:str", _str_constructor)


def _parse_tagged(stream) -> Any:
    return yaml.load(stream, Loader=_TaggedLoader)


# ---------------------------------------------------------------------------
# Override merging
# ---------------------------------------------------------------------------

def recursive_update(d, u, must_match: bool = False,
                     keep_objects: bool = False):
    """Nested dict update with HyperPyYAML's tag-override semantics.

    Matches reference ``core.py:664-717`` including the local patch for
    tagged-scalar overrides: overriding key ``k`` with a *tagged scalar*
    (e.g. ``model: !include:path``) replaces only the TAG of the existing
    node, keeping its children — which then act as overrides for the included
    file.  Overriding a tagged scalar with a mapping converts it to a tagged
    mapping with the same tag.

    ``keep_objects=True`` is for the post-materialization re-merge of the
    ``extra_overrides`` channel: a dict override whose target is a
    *constructed object* (not a mapping) is skipped instead of clobbering
    the object — those keys already reached the constructor through the
    pre-materialization merge.
    """
    if u is None:
        return
    for k, v in u.items():
        is_tagged_scalar_override = isinstance(v, TaggedValue) and not isinstance(
            v.value, (dict, list)
        )
        if isinstance(v, dict) and not isinstance(v, TaggedValue) and k in d:
            if isinstance(d[k], TaggedValue) and not isinstance(d[k].value, dict):
                # a dict override of a tagged non-mapping node (e.g.
                # ``!apply:f [1, 2]`` overridden with ``{kw: 3}``) keeps the
                # tag but REPLACES the payload with kwargs — flag the drop
                if d[k].value not in (None, "", [], {}):
                    warnings.warn(
                        f"override of {k!r} replaces the tagged node's "
                        f"non-mapping payload {d[k].value!r} with kwargs")
                d[k] = TaggedValue(d[k].tag, {})
            target = d[k]
            if isinstance(target, TaggedValue):
                recursive_update(target.value, v, keep_objects=keep_objects)
            elif isinstance(target, dict):
                recursive_update(target, v, keep_objects=keep_objects)
            elif keep_objects:
                continue
            else:
                d[k] = v
        elif must_match and k not in d:
            raise KeyError(
                f"Override '{k}' not found in: {[key for key in d.keys()]}"
            )
        elif is_tagged_scalar_override and k in d:
            existing = d[k]
            if isinstance(existing, TaggedValue):
                existing.tag = v.tag
                # A bare tagged scalar override of another tagged scalar also
                # carries no value payload; keep existing children if any.
                if not isinstance(existing.value, (dict, list)):
                    existing.value = v.value
            elif isinstance(existing, dict):
                d[k] = TaggedValue(v.tag, existing)
            else:
                d[k] = v
        else:
            d[k] = v


# ---------------------------------------------------------------------------
# Reference resolution
# ---------------------------------------------------------------------------

_REF_RE = re.compile(r"<[^>]*>")

_AST_OPS = {
    ast.Add: op.add,
    ast.Sub: op.sub,
    ast.Mult: op.mul,
    ast.Div: op.truediv,
    ast.FloorDiv: op.floordiv,
    ast.Pow: op.pow,
    ast.Mod: op.mod,
    ast.USub: op.neg,
    ast.UAdd: op.pos,
}


def _ast_eval(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return node.value
    if isinstance(node, ast.BinOp):
        return _AST_OPS[type(node.op)](_ast_eval(node.left), _ast_eval(node.right))
    if isinstance(node, ast.UnaryOp):
        return _AST_OPS[type(node.op)](_ast_eval(node.operand))
    raise TypeError(node)


def parse_arithmetic(reference_string):
    """Evaluate ``+ - * / // ** %`` over numeric literals; else pass through."""
    try:
        return _ast_eval(ast.parse(reference_string, mode="eval").body)
    except (TypeError, SyntaxError, KeyError, ValueError):
        return reference_string


def _deref(ref: str, full_tree, copy_mode: bool = False):
    """Find the node referred to by ``x[y][z]`` or ``x.attr`` notation."""
    attr = None
    if "." in ref:
        ref, attr = ref.split(".", maxsplit=1)

    branch = full_tree
    for part in ref.split("["):
        part = part.strip("]")
        node = branch.value if isinstance(branch, TaggedValue) else branch
        if isinstance(node, dict):
            if part not in node:
                raise ValueError(f'The reference "{ref}" is not valid')
            branch = node[part]
        elif isinstance(node, list):
            try:
                branch = node[int(part)]
            except (ValueError, IndexError):
                raise ValueError(f'The reference "{ref}" is not valid')
        else:
            raise ValueError(f'The reference "{ref}" is not valid')

    if copy_mode:
        return copy.deepcopy(branch)
    if attr is not None:
        return TaggedValue("!apply:getattr", [branch, attr])
    return branch


def recursive_resolve(reference, reference_list, full_tree, copy_mode=False):
    """Resolve chained references with type preservation, interpolation,
    and arithmetic — semantics of reference ``core.py:555-615``."""
    if not isinstance(reference, str) or not _REF_RE.search(reference):
        return reference

    if len(reference_list) > 1 and reference in reference_list[1:]:
        raise ValueError("Circular reference detected: " + str(reference_list))

    if _REF_RE.fullmatch(reference):
        value = _deref(reference.strip("<>"), full_tree, copy_mode)
        reference_list += [reference]
        if isinstance(value, TaggedValue) and value.tag in ("!ref", "!copy"):
            return recursive_resolve(
                value.value, reference_list, full_tree,
                copy_mode or value.tag == "!copy",
            )
        return recursive_resolve(value, reference_list, full_tree, copy_mode)

    matches = _REF_RE.findall(reference)
    # record the FULL string too: a circular interpolated ref
    # (``a: !ref <a>/x``) re-enters with the same full string, which the
    # entry check catches — recording only '<a>' would recurse forever
    reference_list += list(matches) + [reference]

    def replace_fn(m):
        val = _deref(m.group(0).strip("<>"), full_tree, copy_mode)
        if isinstance(val, TaggedValue) and val.tag in ("!ref", "!copy"):
            val = recursive_resolve(val.value, reference_list, full_tree, copy_mode)
        return str(val)

    sub = _REF_RE.sub(replace_fn, reference)
    reference = recursive_resolve(sub, reference_list, full_tree, copy_mode)
    return parse_arithmetic(reference)


def _walk_tree_and_resolve(key, current_node, tree, overrides, file_path):
    """Resolve ``!ref``/``!copy``, splice ``!include:``, flag ``!PLACEHOLDER``.

    Children are walked before tags are handled, exactly like reference
    ``core.py:324-407`` — so refs inside an include-tagged mapping resolve
    against the OUTER document before being handed to the included file as
    overrides.
    """
    inner = current_node.value if isinstance(current_node, TaggedValue) else current_node

    if isinstance(inner, list):
        for i, sub_node in enumerate(inner):
            sub_key = i if key == "root" else f"{key}[{i}]"
            inner[i] = _walk_tree_and_resolve(sub_key, sub_node, tree, overrides, file_path)
    elif isinstance(inner, dict):
        for k in list(inner.keys()):
            sub_key = k if key == "root" else f"{key}[{k}]"
            inner[k] = _walk_tree_and_resolve(sub_key, inner[k], tree, overrides, file_path)

    if isinstance(current_node, TaggedValue):
        tag_value = current_node.tag or ""

        if tag_value == "!PLACEHOLDER":
            raise ValueError(f"'{key}' is a !PLACEHOLDER and must be replaced.")

        if tag_value in ("!ref", "!copy"):
            return recursive_resolve(
                reference=current_node.value,
                reference_list=[],
                full_tree=tree,
                copy_mode=(tag_value == "!copy"),
            )

        if tag_value.startswith("!include:"):
            filename = tag_value[len("!include:"):]
            if file_path is not None:
                filename = os.path.join(file_path, filename)
            child_overrides = None
            if isinstance(current_node.value, dict):
                if overrides:
                    merged = copy.deepcopy(overrides)
                    recursive_update(merged, current_node.value)
                    child_overrides = merged
                else:
                    child_overrides = dict(current_node.value)
            with open(filename) as f:
                included = _resolve_tree(f, child_overrides)
            return included

    return current_node


def _resolve_tree(yaml_stream, overrides=None, overrides_must_match=False):
    """Parse + merge overrides + resolve refs/includes; returns tagged tree."""
    file_path = None
    if hasattr(yaml_stream, "name"):
        file_path = os.path.dirname(os.path.realpath(yaml_stream.name))

    preview = _parse_tagged(yaml_stream)
    if preview is None:
        preview = {}

    def handle_overrides(ovr):
        if isinstance(ovr, str):
            ovr = _parse_tagged(ovr)
        recursive_update(preview, ovr, must_match=overrides_must_match)

    if overrides and isinstance(overrides, list):
        for o in overrides:
            handle_overrides(o)
    elif overrides:
        handle_overrides(overrides)

    _walk_tree_and_resolve("root", preview, preview, {}, file_path)
    return preview


def resolve_references(yaml_stream, overrides=None, overrides_must_match=False):
    """API-parity wrapper: return a resolved YAML stream (reference
    ``core.py:261-321``).  Constructor tags are preserved."""
    tree = _resolve_tree(yaml_stream, overrides, overrides_must_match)
    out = StringIO()
    yaml.dump(_to_dumpable(tree), out, Dumper=_TaggedDumper, sort_keys=False)
    out.seek(0)
    return out


class _TaggedDumper(yaml.SafeDumper):
    pass


def _tagged_representer(dumper: _TaggedDumper, data: TaggedValue):
    if isinstance(data.value, dict):
        return dumper.represent_mapping(data.tag, data.value)
    if isinstance(data.value, list):
        return dumper.represent_sequence(data.tag, data.value)
    return dumper.represent_scalar(data.tag, str(data.value))


_TaggedDumper.add_representer(TaggedValue, _tagged_representer)
_TaggedDumper.add_representer(
    type(None), lambda d, _: d.represent_scalar("tag:yaml.org,2002:null", "null")
)


def _to_dumpable(node):
    if isinstance(node, TaggedValue):
        return TaggedValue(node.tag, _to_dumpable(node.value))
    if isinstance(node, dict):
        return {k: _to_dumpable(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_dumpable(v) for v in node]
    return node


def dump_hyperyaml(yaml_tree, output_stream, *args, **kwargs):
    """Dump a tree that may contain Placeholder/RefTag sentinels."""

    def convert(node):
        if isinstance(node, Placeholder):
            return TaggedValue("!PLACEHOLDER", "")
        if isinstance(node, RefTag):
            return TaggedValue("!ref", node.ref_str)
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, list):
            return [convert(v) for v in node]
        return node

    yaml.dump(
        _to_dumpable(convert(yaml_tree)),
        output_stream,
        Dumper=_TaggedDumper,
        sort_keys=False,
        default_flow_style=False,
    )


# ---------------------------------------------------------------------------
# Materialization (construction)
# ---------------------------------------------------------------------------

_TUPLE_RE = re.compile(r"^\(.*\)$")


def _maybe_tuple(value):
    if isinstance(value, str) and _TUPLE_RE.match(value):
        inner = yaml.safe_load("[" + value[1:-1] + "]")
        return tuple(inner)
    return value


def _split_args(value, memo):
    if isinstance(value, dict):
        return [], {k: _materialize(v, memo) for k, v in value.items()}
    if isinstance(value, list):
        return [_materialize(v, memo) for v in value], {}
    if value in (None, ""):
        return [], {}
    return [_materialize(value, memo)], {}


class _Memo(dict):
    """Node id -> built object, and what every port callable is handed:
    the run's device (resolved on first use, so a YAML that builds no
    module never asks for one) and its generator (made on that device on
    first use unless the caller passed one)."""

    def __init__(self, device=None, generator=None):
        super().__init__()
        self._device_arg = device
        self._device = None
        self._generator = generator

    @property
    def device(self):
        if self._device is None:
            from mlvae_tpu_torch.device import resolve_device
            self._device = resolve_device(self._device_arg)
        return self._device

    @property
    def generator(self):
        if self._generator is None:
            import torch
            self._generator = torch.Generator(device=self.device)
        return self._generator


def _inject(target, kwargs: Dict[str, Any], memo: _Memo) -> Dict[str, Any]:
    """``kwargs`` plus the run's ``device`` and ``generator`` for a port
    callable that takes them and is not given them by the YAML."""
    if not getattr(target, "__module__", "").startswith("mlvae_tpu_torch"):
        return kwargs
    try:
        params = inspect.signature(target).parameters
    except (TypeError, ValueError):
        return kwargs
    out = dict(kwargs)
    if "device" in params and "device" not in out:
        out["device"] = memo.device
    if "generator" in params and "generator" not in out:
        out["generator"] = memo.generator
    return out


def _materialize(node, memo: Dict[int, Any]):
    if id(node) in memo:
        return memo[id(node)]

    if isinstance(node, TaggedValue):
        tag = node.tag or ""
        if tag.startswith("!new:"):
            name = tag[len("!new:"):]
            callable_ = locate(name)
            if callable_ is None:
                raise ImportError(f"There is no such class as {name}")
            if not inspect.isclass(callable_):
                raise ValueError(f"!new:{name} should be a class, but is {callable_}")
            args, kwargs = _split_args(node.value, memo)
            result = callable_(*args, **_inject(callable_, kwargs, memo))
        elif tag.startswith("!name:"):
            name = tag[len("!name:"):]
            target = locate(name)
            if target is None:
                raise ImportError(f"There is no such entity as {name}")
            args, kwargs = _split_args(node.value, memo)
            if not (inspect.isclass(target) or inspect.isroutine(target)):
                if args or kwargs:
                    raise ValueError(
                        f"!name:{name} with args must be a class or function"
                    )
                result = target
            else:
                result = functools.partial(
                    target, *args, **_inject(target, kwargs, memo))
        elif tag.startswith("!module:"):
            name = tag[len("!module:"):]
            module = locate(name)
            if module is None:
                raise ImportError(f"There is no such module as {name}")
            if not inspect.ismodule(module):
                raise ValueError(f"!module:{name} is not a module")
            if node.value not in (None, "", [], {}):
                # reference core.py: 'Cannot pass args to module'
                raise ValueError(f"Cannot pass args to module {name}")
            result = module
        elif tag.startswith("!apply:"):
            name = tag[len("!apply:"):]
            callable_ = locate(name)
            if callable_ is None:
                raise ImportError(f"There is no such callable as {name}")
            args, kwargs = _split_args(node.value, memo)
            result = callable_(*args, **_inject(callable_, kwargs, memo))
        elif tag == "!tuple":
            result = _maybe_tuple(str(node.value))
        elif tag == "!PLACEHOLDER":
            raise ValueError("!PLACEHOLDER must be replaced before loading.")
        else:
            raise ValueError(f"Unknown tag: {tag}")
        memo[id(node)] = result
        return result

    if isinstance(node, dict):
        result = {k: _materialize(v, memo) for k, v in node.items()}
        memo[id(node)] = result
        return result
    if isinstance(node, list):
        result = [_materialize(v, memo) for v in node]
        memo[id(node)] = result
        return result
    # plain-scalar tuple conversion already happened at parse time
    # (_str_constructor); quoted strings pass through untouched
    return node


def load_hyperyaml(
    yaml_stream,
    overrides=None,
    overrides_must_match: bool = True,
    extra_overrides=None,
    device=None,
    generator=None,
) -> Dict[str, Any]:
    """Load a HyperPyYAML-dialect config into a dict of live objects,
    signature-compatible with the JAX package's ``load_hyperyaml`` plus
    ``device`` (None means CUDA) and ``generator`` for the port's
    modules."""
    if extra_overrides:
        # merged BEFORE reference resolution (same as the CLI channel,
        # experiment.py) so tagged override values materialize and keys
        # that other values !ref see the overridden value, not the stale
        # one.  Ordered last: extra_overrides win over plain overrides.
        ovr = overrides if isinstance(overrides, list) \
            else ([overrides] if overrides else [])
        overrides = ovr + [extra_overrides]
    tree = _resolve_tree(yaml_stream, overrides, overrides_must_match)
    hparams = _materialize(tree, _Memo(device, generator))
    if isinstance(hparams, dict):
        for k in [k for k in hparams if str(k).startswith("__")]:
            del hparams[k]
    return hparams


# the reference name (HyperPyYAML's own)
load_hyperpyyaml = load_hyperyaml
