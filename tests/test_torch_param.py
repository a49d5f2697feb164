"""PyTorch port vs the JAX package: the parameter structs.

The cases of ``tests/test_param.py`` run on both packages' ``Parameter``
with one struct declared in each, and every observable answer must agree:
values, unknown-key dicts, the hidden-key rule, error types, the JSON text
(byte for byte, so a parameter file saved by either package loads in the
other), ``get_field_info``/``doc_string`` and equality.
"""

import io
import json

import pytest

from dmlc_core_tpu import param as jax_param
from dmlc_core_tpu.models.gbdt import GBDTParam as JaxGBDTParam
from dmlc_core_tpu.models.linear import LinearParam as JaxLinearParam
from dmlc_core_tpu.models.mlp import MLPParam as JaxMLPParam
from dmlc_core_tpu_torch import param as port_param
from dmlc_core_tpu_torch.models.gbdt import GBDTParam
from dmlc_core_tpu_torch.models.linear import LinearParam
from dmlc_core_tpu_torch.models.mlp import MLPParam

PAIRS = {"gbdt": (JaxGBDTParam, GBDTParam),
         "linear": (JaxLinearParam, LinearParam),
         "mlp": (JaxMLPParam, MLPParam)}


def _my_param(mod):
    class MyParam(mod.Parameter):
        num_hidden = mod.field(int, help="number of hidden units")
        learning_rate = mod.field(float, default=0.01, lower=0.0, upper=1.0,
                                  help="step size")
        name = mod.field(str, default="layer", help="layer name")
        act = mod.field(str, default="relu",
                        enum=["relu", "tanh", "sigmoid"], help="activation")
        use_bias = mod.field(bool, default=True, help="whether to use bias")
        seed = mod.field(int, optional=True, help="optional RNG seed")
        mode = mod.field(int, default=0, enum={"dense": 0, "sparse": 1})

    return MyParam


MINE = {"jax": _my_param(jax_param), "port": _my_param(port_param)}


def _both(fn):
    """``fn(struct_class, module)`` on both packages: (jax, port)."""
    return (fn(MINE["jax"], jax_param), fn(MINE["port"], port_param))


def test_hidden_keys_are_skipped():
    j = JaxGBDTParam(__hidden__=1, max_depth=4)
    p = GBDTParam(__hidden__=1, max_depth=4)
    assert p.to_dict() == j.to_dict() and p.max_depth == 4
    # short dunder-shaped keys are not hidden: both refuse them
    for cls in (JaxGBDTParam, GBDTParam):
        with pytest.raises(ValueError, match="____"):
            cls(**{"____": 1})
    got = _both(lambda P, m: P().init({"num_hidden": 1, "__secret__": "x",
                                       "__a__": 2}))
    assert got == ({}, {})


def test_init_allow_unknown_matches():
    kw = {"num_hidden": "3", "batch": 5, "__x__": 1, "learning_rate": "0.5"}
    got = _both(lambda P, m: (P().init(dict(kw), allow_unknown=True),
                              P(num_hidden=3, learning_rate=0.5).to_dict()))
    assert got[0] == got[1] == ({"batch": 5}, got[0][1])
    for cls_j, cls_p in PAIRS.values():
        extra = {"num_feature": 8, "not_a_field": "v", "__h__": 0}
        got = cls_p().init(dict(extra), allow_unknown=True)
        assert got == cls_j().init(dict(extra), allow_unknown=True)
        assert "not_a_field" in got and "__h__" not in got


@pytest.mark.parametrize("kw,pattern", [
    ({}, "num_hidden"),
    ({"num_hidden": 1, "batch": 5}, "batch"),
    ({"num_hidden": 1, "learning_rate": 2.0}, "exceeds bound"),
    ({"num_hidden": 1, "learning_rate": -0.5}, "exceeds bound"),
    ({"num_hidden": 1, "act": "gelu"}, "act"),
    ({"num_hidden": 1, "use_bias": "maybe"}, "use_bias"),
    ({"num_hidden": "abc"}, "num_hidden"),
    ({"num_hidden": 1.5}, "num_hidden"),
    ({"num_hidden": 1, "mode": "ragged"}, "mode"),
])
def test_init_errors_match(kw, pattern):
    msgs = []
    for P, mod in ((MINE["jax"], jax_param), (MINE["port"], port_param)):
        with pytest.raises(mod.ParamError, match=pattern) as err:
            P().init(dict(kw))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_values_enum_map_bool_and_update_match():
    def run(P, m):
        p = P()
        p.init({"num_hidden": 100, "learning_rate": "0.1", "mode": "sparse",
                "use_bias": "false", "seed": "None"})
        p.update({"learning_rate": 0.5, "nonexistent": 1, "act": "tanh"})
        return (p.num_hidden, p.learning_rate, p.mode, p.use_bias, p.seed,
                p.act, p.to_dict(), repr(p))
    j, p = _both(run)
    assert j == p
    assert p[2] == 1 and p[6]["mode"] == "sparse" and p[4] is None


@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_to_json_is_byte_identical(kind):
    cls_j, cls_p = PAIRS[kind]
    kw = {"gbdt": dict(max_depth=5, subsample=0.8, hist_method="scatter",
                       handle_missing=True, monotone_constraints="(1,0)",
                       seed=-3),
          "linear": dict(num_feature=28, learning_rate=0.25),
          "mlp": dict(num_feature=28, hidden="64,32", bf16=False)}[kind]
    text = cls_p(**kw).to_json()
    assert text == cls_j(**kw).to_json()
    assert json.loads(text) == cls_j(**kw).to_dict()
    # a file saved by either package loads in the other
    back_p, back_j = cls_p(), cls_j()
    back_p.load_json(cls_j(**kw).to_json())
    back_j.load_json(text)
    assert back_p == cls_p(**kw) and back_j == cls_j(**kw)
    for src, dst in ((cls_p(**kw), cls_j()), (cls_j(**kw), cls_p())):
        buf = io.BytesIO()
        src.save(buf)
        dst.load_json(buf.getvalue().decode("utf-8"))
        assert dst.to_dict() == src.to_dict()


def test_load_json_refuses_non_objects():
    for mod, P in ((jax_param, MINE["jax"]), (port_param, MINE["port"])):
        with pytest.raises(mod.ParamError, match="object"):
            P().load_json("[1, 2]")


def test_equality_and_hash():
    def run(P, m):
        a, b, c = P(num_hidden=7), P(num_hidden=7), P(num_hidden=8)
        return (a == b, a == c, hash(a) == hash(b), len({a, b, c}),
                a == object())
    assert _both(run) == ((True, False, True, 2, False),) * 2
    assert GBDTParam(max_depth=3) == GBDTParam(max_depth=3)
    assert GBDTParam(max_depth=3) != GBDTParam(max_depth=4)
    assert hash(GBDTParam(seed=2)) == hash(GBDTParam(seed=2))


def test_field_info_and_doc_string_match():
    j, p = _both(lambda P, m: (P.get_field_info(), P.doc_string(),
                               [f.type_str() for f in P.__fields__.values()]))
    assert j == p
    assert "range [0.0, 1.0]" in p[1] and "required" in p[1]
    for cls_j, cls_p in PAIRS.values():
        # field names and type strings (help texts are each package's own)
        assert ([i[:2] for i in cls_p.get_field_info()]
                == [i[:2] for i in cls_j.get_field_info()])


def test_get_env_matches(monkeypatch):
    monkeypatch.setenv("DMLC_TEST_ENV_X", "32")
    monkeypatch.setenv("DMLC_TEST_ENV_B", "true")
    for mod in (jax_param, port_param):
        assert mod.get_env("DMLC_TEST_ENV_X", int, 0) == 32
        assert mod.get_env("DMLC_TEST_ENV_MISSING", int, 7) == 7
        assert mod.get_env("DMLC_TEST_ENV_B", bool, False) is True
