"""Path-scoped quantization policy: per-tensor-class bit-widths per module.

Counterpart of ``repro/core/qpolicy.py`` (pure Python, copied so the port
imports nothing of the JAX package).  Every integer call site has a dotted
path (``"blocks.3.attn.wq"``, ``"embed"``); a ``QuantPolicy`` is an ordered
list of glob rules mapping paths to partial ``QuantConfig`` overrides, and
``resolve(path)`` folds the matching rules over the base config,
most-specific-wins (``(#literal segments, #literal chars)``, ties to the
later rule).  Kernels and ``core.int_ops`` only ever see resolved leaves.

Unlike the reference, a bare ``QuantConfig`` never picks up rules from the
environment (there is no ``$REPRO_QPOLICY`` here).
"""
from __future__ import annotations

import dataclasses
import fnmatch
import functools
import json
import warnings
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.core.qconfig import PRESETS as CONFIG_PRESETS
from repro_torch.core.qconfig import (QuantConfig, StabilityWarning,
                                      stability_violated)

_CONFIG_FIELDS = frozenset(f.name for f in dataclasses.fields(QuantConfig))
_WILD = "*?["


def _freeze_overrides(overrides: Mapping[str, Any]) -> Tuple[Tuple[str, Any], ...]:
    bad = set(overrides) - _CONFIG_FIELDS
    if bad:
        raise ValueError(f"unknown QuantConfig field(s) in rule overrides: "
                         f"{sorted(bad)}; have {sorted(_CONFIG_FIELDS)}")
    return tuple(sorted(overrides.items()))


@dataclasses.dataclass(frozen=True)
class ScopeRule:
    """One glob pattern -> partial QuantConfig override."""

    pattern: str
    overrides: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self):
        if not isinstance(self.pattern, str) or not self.pattern:
            raise ValueError("rule pattern must be a non-empty string")
        object.__setattr__(self, "overrides",
                           _freeze_overrides(dict(self.overrides)))

    def matches(self, path: str) -> bool:
        return fnmatch.fnmatchcase(path, self.pattern)


def rule(pattern: str, **overrides: Any) -> ScopeRule:
    """Convenience constructor: ``rule("embed*", weight_bits=16)``."""
    return ScopeRule(pattern=pattern, overrides=tuple(overrides.items()))


def specificity(pattern: str) -> Tuple[int, int]:
    """``(#literal segments, #literal chars)`` — the precedence key."""
    segs = pattern.split(".")
    lit_segs = sum(1 for s in segs if s and not any(c in s for c in _WILD))
    lit_chars = sum(1 for c in pattern if c not in "*?[]")
    return (lit_segs, lit_chars)


@functools.lru_cache(maxsize=8192)
def _resolve(policy: "QuantPolicy", paths: Tuple[str, ...]) -> QuantConfig:
    matched = []
    for idx, r in enumerate(policy.rules):
        if any(r.matches(p) for p in paths):
            matched.append((specificity(r.pattern), idx, r))
    if not matched:
        return policy.base            # identity: bare-config fast path
    matched.sort(key=lambda t: (t[0], t[1]))
    over: Dict[str, Any] = {}
    for _, _, r in matched:
        over.update(dict(r.overrides))
    with warnings.catch_warnings():
        # emitted uncached by QuantPolicy.resolve instead
        warnings.simplefilter("ignore", StabilityWarning)
        return dataclasses.replace(policy.base, **over)


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Frozen ordered rule list over a base ``QuantConfig``."""

    base: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    rules: Tuple[ScopeRule, ...] = ()

    def __post_init__(self):
        if not isinstance(self.base, QuantConfig):
            raise TypeError(
                f"QuantPolicy.base must be a QuantConfig, got "
                f"{type(self.base).__name__}; policies do not nest — "
                "compose rule lists instead")
        object.__setattr__(self, "rules", tuple(
            r if isinstance(r, ScopeRule) else ScopeRule(*r)
            for r in self.rules))

    @property
    def uniform(self) -> bool:
        """True when resolution cannot depend on the path."""
        return not self.rules

    def resolve(self, path: Union[str, Sequence[str]]) -> QuantConfig:
        """Resolved leaf config for ``path`` (or any of its alias paths)."""
        paths = (path,) if isinstance(path, str) else tuple(path)
        leaf = _resolve(self, paths)
        if (leaf is not self.base
                and leaf.warn_stability and stability_violated(leaf)):
            warnings.warn(
                f"policy resolution at {paths[0]!r} lands in the Fig. 4 "
                f"divergence regime (weight_bits=8, act_bits="
                f"{leaf.act_bits} < 12); override warn_stability=False in "
                "the rule to silence", StabilityWarning, stacklevel=2)
        return leaf

    # -- JSON round trip (the policy's storage format) --------------------
    def to_json(self) -> str:
        """The port's fields, ``sort_keys=True`` like the reference's
        document, so the reference's ``from_json`` reads it back (its
        missing ``backend`` takes the reference's default)."""
        doc = {
            "base": dataclasses.asdict(self.base),
            "rules": [{"pattern": r.pattern, "overrides": dict(r.overrides)}
                      for r in self.rules],
        }
        return json.dumps(doc, sort_keys=True)

    @staticmethod
    def from_json(doc: Union[str, Mapping[str, Any]]) -> "QuantPolicy":
        """A policy from the port's or the reference's document.  The
        reference's ``backend`` key (in the base or a rule) is dropped: the
        port has no backend switch, its kernels follow the reference's
        Pallas route wherever the tensors lie."""
        if isinstance(doc, str):
            doc = json.loads(doc)
        base = {k: v for k, v in doc.get("base", {}).items()
                if k != "backend"}
        rules = tuple(
            ScopeRule(pattern=r["pattern"], overrides=tuple(
                (k, v) for k, v in r.get("overrides", {}).items()
                if k != "backend"))
            for r in doc.get("rules", ()))
        return QuantPolicy(base=QuantConfig(**base), rules=rules)

    @staticmethod
    def preset(name: str) -> "QuantPolicy":
        return preset(name)


@dataclasses.dataclass(frozen=True)
class Scope:
    """A ``QuantPolicy`` plus the dotted path of the current module;
    ``aliases`` holds alternative spellings (the negative layer index)."""

    policy: QuantPolicy = dataclasses.field(default_factory=QuantPolicy)
    path: Tuple[str, ...] = ()
    aliases: Tuple[Tuple[str, ...], ...] = ()

    def _paths_for(self, extra: Tuple[str, ...]) -> Tuple[str, ...]:
        return tuple(".".join(p + extra)
                     for p in (self.path,) + self.aliases)

    def child(self, name: str, alias: Optional[str] = None) -> "Scope":
        """Descend one level; ``alias`` registers an alternative segment."""
        segs = tuple(str(name).split("."))
        new_aliases: List[Tuple[str, ...]] = [a + segs for a in self.aliases]
        if alias is not None:
            asegs = tuple(str(alias).split("."))
            new_aliases += [p + asegs
                            for p in (self.path,) + self.aliases]
        return Scope(policy=self.policy, path=self.path + segs,
                     aliases=tuple(new_aliases))

    def cfg(self) -> QuantConfig:
        """Resolved leaf config at the scope's own path."""
        return self.policy.resolve(self._paths_for(()))

    def leaf(self, name: str) -> QuantConfig:
        """Resolved leaf config at ``path + "." + name``."""
        return self.policy.resolve(self._paths_for(tuple(name.split("."))))


QuantLike = Union[QuantConfig, QuantPolicy, Scope]


class PolicyScopeError(ValueError):
    """A policy's scope rules cannot be realized on this model structure
    (e.g. per-layer-index rules on an interleaved stack).  Sweep drivers
    catch this to record the cell as skipped, not failed."""


def as_policy(q: QuantLike) -> QuantPolicy:
    """Coerce config-or-policy to a policy (a bare config has no rules)."""
    if isinstance(q, Scope):
        return q.policy
    if isinstance(q, QuantPolicy):
        return q
    if isinstance(q, QuantConfig):
        return QuantPolicy(base=q)
    raise TypeError(f"expected QuantConfig | QuantPolicy | Scope, got "
                    f"{type(q).__name__}")


def ensure_scope(q: QuantLike) -> Scope:
    """Coerce any quantization argument to a root-or-descended ``Scope``."""
    if isinstance(q, Scope):
        return q
    return Scope(policy=as_policy(q))


def layer_scope(scope: Scope, stack: str, i: int, n: int) -> Scope:
    """Scope of layer ``i`` of an ``n``-deep stack, with the negative-index
    alias (``blocks.-1`` == last layer)."""
    return scope.child(stack).child(str(i), alias=str(i - n))


def layer_groups(scope: Scope, n: int, leaves: Sequence[str],
                 stack: str = "blocks") -> List[Tuple[int, int, Scope]]:
    """Partition layers ``0..n-1`` into maximal runs whose resolved leaf
    configs are identical: ``[(start, stop, scope_of_first_layer)]``."""
    scopes = [layer_scope(scope, stack, i, n) for i in range(n)]
    if scope.policy.uniform:
        return [(0, n, scopes[0])]
    keys = [tuple(s.leaf(l) for l in leaves) for s in scopes]
    groups: List[Tuple[int, int, Scope]] = []
    start = 0
    for i in range(1, n + 1):
        if i == n or keys[i] != keys[start]:
            groups.append((start, i, scopes[start]))
            start = i
    return groups


_HI16 = (("act_bits", 16), ("grad_bits", 16), ("weight_bits", 16))

#: policy presets: name -> (base config preset, rule tuple)
_POLICY_TABLE: Dict[str, Tuple[str, Tuple[ScopeRule, ...]]] = {
    "int8_embed16": ("int8", (
        ScopeRule("*embed*", _HI16),
        ScopeRule("*head*", _HI16),
    )),
    "int8_firstlast16": ("int8", (
        ScopeRule("*embed*", _HI16),
        ScopeRule("*head*", _HI16),
        ScopeRule("blocks.0.*", _HI16),
        ScopeRule("blocks.-1.*", _HI16),
        ScopeRule("enc.0.*", _HI16),
        ScopeRule("enc.-1.*", _HI16),
        ScopeRule("dec.0.*", _HI16),
        ScopeRule("dec.-1.*", _HI16),
    )),
}

POLICY_PRESETS = tuple(_POLICY_TABLE)


def preset_rules(name: str) -> Tuple[ScopeRule, ...]:
    """The rule list of a policy preset (base config not included)."""
    if name not in _POLICY_TABLE:
        raise KeyError(f"unknown policy preset {name!r}; "
                       f"have {sorted(_POLICY_TABLE)}")
    return _POLICY_TABLE[name][1]


def preset(name: str) -> QuantPolicy:
    """A *policy* preset by name."""
    rules = preset_rules(name)
    return QuantPolicy(base=QuantConfig.preset(_POLICY_TABLE[name][0]),
                       rules=rules)


def get(name: str) -> QuantLike:
    """Unified preset lookup: config presets -> ``QuantConfig``, policy
    presets -> ``QuantPolicy``."""
    if name in _POLICY_TABLE:
        return preset(name)
    if name in CONFIG_PRESETS:
        return QuantConfig.preset(name)
    raise KeyError(f"unknown quant preset {name!r}; have "
                   f"{sorted(CONFIG_PRESETS) + sorted(_POLICY_TABLE)}")


ALL_PRESETS = tuple(CONFIG_PRESETS) + POLICY_PRESETS
