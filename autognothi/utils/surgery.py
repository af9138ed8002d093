"""Weight-surgery DSL over flat parameter dicts.

The JAX rebuild stores every model's parameters as a *flat* dict mapping
torch-style dotted names (e.g. ``"vit.encoder.layers.3.attention.self.query.
weight"``) to arrays.  This module re-creates the reference's declarative
state-dict merge language (see /root/reference/utils/nnmodel.py:63-191) over
those dicts:

    rules = {
        "pat.{i}.{wb}": ...,            # keep under the same name
        "pat.{i}.{wb}": "other.{i}.{wb}",  # rename
        "pat.{i}.{wb}": None,           # drop
        "pat.{i}.{wb}": [..., "b.{i}"], # fan out (copies for non-first)
        New(): "dst.{i}.{wb}",          # take from destination's fresh init
    }
    merged = merge_param_dicts((rules, src_params), into=dst_params)

Every source key must be consumed by some rule and every destination key must
either be produced or claimed by a `New()` rule — otherwise the merge fails
closed with a ValueError listing the offending keys.  This is the engine
behind every stage conversion (classifier -> surrogate -> explainer -> final)
and behind HF-checkpoint import.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from .strings import pattern_replace

__all__ = ["New", "MergeRules", "merge_param_dicts", "MergeError"]


class New:
    """Marker key: 'take this destination entry from the fresh init'."""

    _count = 0

    def __init__(self) -> None:
        New._count += 1
        self._id = New._count

    def __repr__(self) -> str:  # pragma: no cover
        return "New()"

    def __hash__(self) -> int:
        return self._id


RuleValue = Union[str, type(Ellipsis), List[Union[str, type(Ellipsis)]], None]
MergeRules = Dict[Union[str, New], RuleValue]


class MergeError(ValueError):
    pass


def _copy_array(v: Any) -> Any:
    if isinstance(v, np.ndarray):
        return v.copy()
    try:  # jax arrays: functional, a reference copy is safe, but keep parity
        import jax.numpy as jnp

        if isinstance(v, jnp.ndarray):
            return jnp.array(v)
    except Exception:  # pragma: no cover
        pass
    return v


def merge_param_dicts(
    *rules_src: Tuple[MergeRules, Dict[str, Any]],
    into: Dict[str, Any],
    duplicate_action: Optional[Callable[[Any], Any]] = None,
) -> Dict[str, Any]:
    """Merge one or more (rules, source-dict) pairs into the layout of `into`.

    Returns a new flat dict with exactly the same key set as `into` (verified
    fail-closed).  `into` itself is never mutated.
    """
    dup = duplicate_action or _copy_array
    problems: List[str] = []

    # Compile each source's rules into edit/remove rewriters; collect New().
    new_templates: Dict[str, List[str]] = {}
    compiled: List[Tuple[Callable, Callable, Dict[str, Any]]] = []
    for rules, src in rules_src:
        edit_rules: Dict[str, List[str]] = {}
        rm_rules: Dict[str, List[str]] = {}
        for key, val in rules.items():
            if isinstance(key, New):
                if not isinstance(val, str):
                    raise MergeError(f"New() rule needs a str target, got {val!r}")
                new_templates[val] = ["<NEW>"]
            elif isinstance(key, str):
                if val is Ellipsis:
                    edit_rules[key] = [key]
                elif isinstance(val, str):
                    edit_rules[key] = [val]
                elif val is None:
                    rm_rules[key] = ["<RM>"]
                elif isinstance(val, list):
                    targets: List[str] = []
                    for item in val:
                        if item is Ellipsis:
                            targets.append(key)
                        elif isinstance(item, str):
                            targets.append(item)
                        else:
                            raise MergeError(f"invalid rule {key!r} -> {val!r}")
                    if targets:
                        edit_rules[key] = targets
                    else:
                        rm_rules[key] = ["<RM>"]
                else:
                    raise MergeError(f"invalid rule {key!r} -> {val!r}")
            else:
                raise MergeError(f"invalid rule key {key!r}")
        compiled.append((pattern_replace(edit_rules), pattern_replace(rm_rules), src))
    new_matcher = pattern_replace(new_templates)

    result: Dict[str, Any] = {}
    for edit_fn, rm_fn, src in compiled:
        for key, val in src.items():
            matched, new_keys = edit_fn(key)
            if matched:
                for idx, new_key in enumerate(new_keys):
                    if new_key in result:
                        problems.append(f"duplicate key produced: {new_key}")
                    result[new_key] = val if idx == 0 else dup(val)
                continue
            matched, flag = rm_fn(key)
            if matched and flag == ["<RM>"]:
                continue
            problems.append(f"no rule matches source key: {key}")

    for key, val in into.items():
        if key in result:
            continue
        matched, flag = new_matcher(key)
        if matched and flag == ["<NEW>"]:
            result[key] = val
        else:
            problems.append(f"destination key not produced: {key}")

    for key in result:
        if key not in into:
            problems.append(f"produced key absent from destination layout: {key}")

    if problems:
        raise MergeError("merge failed:\n  " + "\n  ".join(problems))
    return result
