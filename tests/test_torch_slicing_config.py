"""Port vs JAX package: the slice DSL (``core/slicing.py``) and the recipe
helpers ``read_yaml`` / ``build_component`` (``config.py``), on the same
inputs; results must be equal and errors of the same type.  Mirrors
``tests/test_core.py:130-165``."""

import numpy as np
import pytest

from confild_tpu import config as jconfig
from confild_tpu.core import slicing as jslicing
from confild_tpu_torch import config as tconfig
from confild_tpu_torch.core import slicing as tslicing

SPECS = [
    ["2:5", ":"],
    [":", "1:-1:2"],
    ["3", ":"],
    [1, " 2 : "],
    [[0, 2, 3], "::2"],
    [(1, 0), 2],
    ["-3:", "::-1"],
    [],
]


@pytest.mark.parametrize("spec", SPECS, ids=[repr(s) for s in SPECS])
def test_indices2slice_matches_jax(spec):
    got, want = tslicing.indices2slice(spec), jslicing.indices2slice(spec)
    assert got == want
    x = np.arange(100).reshape(10, 10)
    if spec and not any(isinstance(p, (list, tuple)) for p in spec):
        assert np.array_equal(x[got], x[want])


@pytest.mark.parametrize("spec,error", [(["1:2:3:4"], ValueError), ([1.5], TypeError),
                                        ([None], TypeError), (["a:b"], ValueError),
                                        (["x"], ValueError)])
def test_indices2slice_errors_match_jax(spec, error):
    with pytest.raises(error):
        jslicing.indices2slice(spec)
    with pytest.raises(error):
        tslicing.indices2slice(spec)


def test_core_package_exports_slicing():
    import confild_tpu_torch.core as tcore
    assert tcore.slicing.indices2slice is tslicing.indices2slice


def test_read_yaml_matches_jax(tmp_path):
    p = tmp_path / "case.yml"
    p.write_text("batch_size: 64\nNF:\n  name: SIRENAutodecoder_film\n  kwargs: {a: [1, 2]}\n")
    assert tconfig.read_yaml(str(p)) == jconfig.read_yaml(str(p))
    empty = tmp_path / "empty.yml"
    empty.write_text("")
    assert tconfig.read_yaml(str(empty)) == jconfig.read_yaml(str(empty)) == {}


REGISTRY = {
    "adder": lambda a, b: a + b,
    "wrap": lambda inner, k: (inner, k),
    "const": lambda **kw: ("const", tuple(sorted(kw.items()))),
}
COMPONENTS = [
    {"name": "wrap", "kwargs": {"inner": {"name": "adder", "kwargs": {"a": 1, "b": 2}},
                                "k": 7}},
    {"name": "wrap", "kwargs": {"inner": {"name": "wrap", "kwargs": {
        "inner": {"name": "adder", "kwargs": {"a": 3, "b": 4}}, "k": 1}}, "k": 2}},
    # a mapping whose name the registry does not know stays a plain value
    {"name": "wrap", "kwargs": {"inner": {"name": "elsewhere", "x": 1}, "k": 0}},
    {"name": "const"},
    "const",
]


@pytest.mark.parametrize("spec", COMPONENTS, ids=range(len(COMPONENTS)))
def test_build_component_matches_jax(spec):
    assert tconfig.build_component(spec, REGISTRY) == jconfig.build_component(spec, REGISTRY)


def test_build_component_extra_kwargs_match_jax():
    spec = {"name": "adder", "kwargs": {"a": 1}}
    assert (tconfig.build_component(spec, REGISTRY, b=5)
            == jconfig.build_component(spec, REGISTRY, b=5) == 6)
    assert (tconfig.build_component("const", REGISTRY, z=1)
            == jconfig.build_component("const", REGISTRY, z=1))


@pytest.mark.parametrize("spec,error", [("nope", KeyError), ({"name": "nope"}, KeyError),
                                        (3, TypeError), (["adder"], TypeError)])
def test_build_component_errors_match_jax(spec, error):
    with pytest.raises(error):
        jconfig.build_component(spec, REGISTRY)
    with pytest.raises(error):
        tconfig.build_component(spec, REGISTRY)
