"""The policy API the port shares with the reference: ``rule``,
``QuantPolicy.to_json`` / ``from_json`` / ``preset`` and
``PolicyScopeError``.  The JSON document is how a policy is stored, so
each package reads the other's: the reference's ``from_json`` of the
port's document and the port's ``from_json`` of the reference's resolve
the same fields at every leaf path below (the reference's ``backend``,
which the port has no field for, aside)."""
import dataclasses
import json

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import qpolicy as jqp  # noqa: E402
from repro_torch.core import qpolicy as qp  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402

PATHS = ("embed", "type_embed", "embed_ln", "patch_embed", "head",
         "span_head", "final_ln", "final_norm", "blocks.0.attn.wq",
         "blocks.0.attn.qk", "blocks.3.attn.pv", "blocks.0.mlp.w1",
         "blocks.11.ln2", "enc.0.attn.wo", "dec.5.mlp.w2", "pooler")
POLICIES = ("int8_embed16", "int8_firstlast16")
CONFIGS = ("fp32", "int16", "int12", "int10", "int8", "int8_naive")
FIELDS = tuple(f.name for f in dataclasses.fields(QuantConfig))


def _port(name):
    if name in POLICIES:
        return qp.QuantPolicy.preset(name)
    return qp.QuantPolicy(base=QuantConfig.preset(name))


def _ref(name):
    base = jqp.QuantConfig.preset("int8" if name in POLICIES else name)
    base = dataclasses.replace(base, backend="pallas")
    return jqp.QuantPolicy(base=base, rules=jqp.preset_rules(name)
                           if name in POLICIES else ())


def _same_fields(port_pol, ref_pol):
    for path in PATHS:
        # the negative-index alias the models add for the last layer
        alias = (path, path.replace(".3.", ".-1.").replace(".11.", ".-1."))
        a, b = port_pol.resolve(alias), ref_pol.resolve(alias)
        for f in FIELDS:
            assert getattr(a, f) == getattr(b, f), (path, f)


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("name", CONFIGS + POLICIES)
def test_port_round_trip(name):
    pol = _port(name)
    doc = pol.to_json()
    assert json.loads(doc) == json.loads(json.dumps(json.loads(doc),
                                                    sort_keys=True))
    back = qp.QuantPolicy.from_json(doc)
    assert back == pol
    assert qp.QuantPolicy.from_json(json.loads(doc)) == pol
    assert back.to_json() == doc


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("name", CONFIGS + POLICIES)
def test_documents_cross_between_packages(name):
    port_pol, ref_pol = _port(name), _ref(name)
    # the reference reads the port's document (its backend at its default)
    from_port = jqp.QuantPolicy.from_json(port_pol.to_json())
    _same_fields(port_pol, from_port)
    # the port reads the reference's, backend dropped, base and rules
    from_ref = qp.QuantPolicy.from_json(ref_pol.to_json())
    assert "backend" in json.loads(ref_pol.to_json())["base"]
    assert from_ref == port_pol
    _same_fields(from_ref, ref_pol)


def test_from_json_drops_backend_in_rules():
    doc = {"base": {"backend": "sim", "weight_bits": 8, "act_bits": 12,
                    "grad_bits": 8},
           "rules": [{"pattern": "*head*",
                      "overrides": {"backend": "pallas", "weight_bits": 16}}]}
    pol = qp.QuantPolicy.from_json(json.dumps(doc))
    assert pol.base == QuantConfig.int8()
    assert pol.rules == (qp.rule("*head*", weight_bits=16),)
    assert pol.resolve("head").weight_bits == 16


def test_rule_and_preset():
    r = qp.rule("embed*", weight_bits=16)
    assert r == qp.ScopeRule("embed*", (("weight_bits", 16),))
    assert r == qp.ScopeRule(**dataclasses.asdict(jqp.rule(
        "embed*", weight_bits=16)))
    pol = qp.QuantPolicy(base=QuantConfig.int8(), rules=(r,))
    assert pol.resolve("embed").weight_bits == 16
    assert pol.resolve("head").weight_bits == 8
    with pytest.raises(ValueError):
        qp.rule("embed*", no_such_field=1)
    for name in POLICIES:
        assert qp.QuantPolicy.preset(name) == qp.preset(name)


def test_policy_scope_error_is_a_value_error():
    assert issubclass(qp.PolicyScopeError, ValueError)
    with pytest.raises(ValueError):
        raise qp.PolicyScopeError("per-layer rules on an interleaved stack")
