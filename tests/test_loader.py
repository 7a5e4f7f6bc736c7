"""Scene loader tests: schema, defaults, and every error path of the
reference loader (reference: src/scene.cpp:154-203) — SURVEY.md §4.2."""

import math

import numpy as np
import pytest

import tpu_ray_tracer as trt
from tpu_ray_tracer.models.errors import SceneError
from tpu_ray_tracer.models import surface

from conftest import SCENE_NAMES, scene_path

MINIMAL = """
width: 100
height: 50
fov: 45
objects:
  - type: sphere
    color: [1, 0, 0]
light_sources:
  - type: directional
    direction: [0, -1, 0]
"""


def test_all_reference_scenes_load():
    expected = {
        "quadratic": (1024, 768, 2, 1),
        "20spheres": (800, 600, 20, 19),
        "reflection_test": (600, 450, 2, 1),
        "dingdong": (1280, 720, 3, 2),
        "cayley": (800, 600, 1, 6),
        "clebsch": (800, 600, 1, 6),
        "cubic": (800, 600, 1, 1),
        "monkey_saddle": (800, 600, 1, 2),
    }
    for name in SCENE_NAMES:
        scene = trt.load_from_file(scene_path(name))
        w, h, n, l = expected[name]
        assert (scene.width, scene.height) == (w, h), name
        assert scene.n_objects == n, name
        assert scene.n_lights == l, name


def test_defaults_applied():
    scene = trt.load_from_string(MINIMAL)
    # max_reflections default 5, bg white (reference: src/scene.cpp:6-7 —
    # the reference docs claim black but the code says white)
    assert scene.max_reflections == 5
    np.testing.assert_array_equal(np.asarray(scene.bg_color), [1.0, 1.0, 1.0])
    # sphere defaults: center (0,0,0), radius 1 -> x2+y2+z2-1
    expected = surface.sphere((0, 0, 0), 1.0)
    np.testing.assert_allclose(np.asarray(scene.coefs[0]), expected)
    # reflection_ratio default 0; light intensity default 1, color white
    assert float(scene.reflection[0]) == 0.0
    np.testing.assert_allclose(np.asarray(scene.light_color[0]), [1, 1, 1])


def test_fov_converted_to_radians():
    scene = trt.load_from_string(MINIMAL)
    assert float(np.asarray(scene.tan_half_fov)) == pytest.approx(
        math.tan(0.5 * math.radians(45.0))
    )


def test_directional_light_stores_negated_unit_direction():
    scene = trt.load_from_string(MINIMAL)
    # p = -normalize(direction) (reference: src/light.cpp:12)
    np.testing.assert_allclose(np.asarray(scene.light_p[0]), [0, 1, 0])
    assert not bool(scene.light_is_spherical[0])


def test_spherical_light_and_intensity_premultiplied():
    scene = trt.load_from_string("""
width: 10
height: 10
fov: 60
objects: []
light_sources:
  - type: spherical
    position: [1, 2, 3]
    intensity: 800
    color: [1, 0.5, 0.25]
""")
    assert bool(scene.light_is_spherical[0])
    np.testing.assert_allclose(np.asarray(scene.light_p[0]), [1, 2, 3])
    np.testing.assert_allclose(
        np.asarray(scene.light_color[0]), [800, 400, 200], rtol=1e-6
    )


def test_missing_required_key_message():
    with pytest.raises(SceneError, match=r"Value 'width' undefined, line: \d+ column: \d+"):
        trt.load_from_string("height: 5\nfov: 30\nobjects: []\nlight_sources: []")


def test_invalid_required_value_message():
    with pytest.raises(SceneError, match=r"Value 'fov' is invalid, line: 3 column: 6"):
        trt.load_from_string("width: 5\nheight: 5\nfov: abc\nobjects: []\nlight_sources: []")


def test_objects_must_be_sequence():
    with pytest.raises(SceneError, match=r"Value 'objects' must be a sequence"):
        trt.load_from_string("width: 5\nheight: 5\nfov: 30\nobjects: {a: 1}\nlight_sources: []")


def test_polynomial_requires_coefficients_map():
    with pytest.raises(SceneError, match=r"Value 'coefficients' undefined"):
        trt.load_from_string("""
width: 5
height: 5
fov: 30
objects:
  - type: polynomial
    color: [1, 1, 1]
light_sources: []
""")


def test_unknown_surface_type_message():
    with pytest.raises(SceneError, match=r"Unknown surface type: 'torus'"):
        trt.load_from_string("""
width: 5
height: 5
fov: 30
objects:
  - type: torus
    color: [1, 1, 1]
light_sources: []
""")


def test_unknown_light_type_message():
    with pytest.raises(SceneError, match=r"Light source type must be 'spherical' or 'directional'"):
        trt.load_from_string("""
width: 5
height: 5
fov: 30
objects: []
light_sources:
  - type: ambient
""")


def test_object_color_required():
    with pytest.raises(SceneError, match=r"Value 'color' undefined"):
        trt.load_from_string("""
width: 5
height: 5
fov: 30
objects:
  - type: sphere
light_sources: []
""")


def test_directional_light_direction_required():
    with pytest.raises(SceneError, match=r"Value 'direction' undefined"):
        trt.load_from_string("""
width: 5
height: 5
fov: 30
objects: []
light_sources:
  - type: directional
""")


def test_color_out_of_range_rejected():
    with pytest.raises(SceneError, match=r"Invalid color"):
        trt.load_from_string("""
width: 5
height: 5
fov: 30
objects:
  - type: sphere
    color: [2, 0, 0]
light_sources: []
""")


def test_negative_intensity_rejected():
    with pytest.raises(SceneError, match=r"Negative value for light intensity"):
        trt.load_from_string("""
width: 5
height: 5
fov: 30
objects: []
light_sources:
  - type: directional
    direction: [0, -1, 0]
    intensity: -1
""")


def test_negative_reflection_ratio_rejected():
    with pytest.raises(SceneError, match=r"Negative value for object reflection ratio"):
        trt.load_from_string("""
width: 5
height: 5
fov: 30
objects:
  - type: sphere
    color: [1, 0, 0]
    reflection_ratio: -0.5
light_sources: []
""")


def test_optional_bad_value_falls_back_silently():
    """yaml-cpp as<T>(fallback) semantics: present-but-invalid optional
    values take the default (reference: src/scene.cpp:160-176)."""
    scene = trt.load_from_string("""
width: 5
height: 5
fov: 30
max_reflections: notanumber
objects:
  - type: sphere
    radius: bogus
    color: [1, 0, 0]
light_sources: []
""")
    assert scene.max_reflections == 5
    np.testing.assert_allclose(
        np.asarray(scene.coefs[0]), surface.sphere((0, 0, 0), 1.0)
    )


def test_missing_file():
    with pytest.raises(SceneError, match=r"Cannot read the file"):
        trt.load_from_file("/nonexistent/scene.yml")


def test_yaml_parse_error():
    with pytest.raises(SceneError, match=r"YAML parser error"):
        trt.load_from_string("width: [unclosed")


def test_vector_must_be_three_elements():
    with pytest.raises(SceneError, match=r"Value 'direction' is invalid"):
        trt.load_from_string("""
width: 5
height: 5
fov: 30
objects: []
light_sources:
  - type: directional
    direction: [0, -1]
""")


def test_import_without_pyyaml():
    """The package parses scenes with its own YAML subset parser: it imports
    and loads a scene with ``yaml`` blocked."""
    import subprocess
    import sys

    repo = scene_path("dingdong").rsplit("/scenes/", 1)[0]
    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "import tpu_ray_tracer as trt\n"
        f"s = trt.load_from_file({scene_path('dingdong')!r})\n"
        "assert (s.width, s.height, s.n_objects) == (1280, 720, 3)\n"
        "assert 'yaml' not in [m for m in sys.modules if sys.modules[m]]\n"
    )
    env = dict(__import__("os").environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("text,expected", [
    # block mapping with a nested block sequence of mappings and a flow list
    ("a:\n  - x: 1\n    y: [1, 2]\n  - z\n",
     {"a": [{"x": "1", "y": ["1", "2"]}, "z"]}),
    # flow mapping nested in a flow sequence; comments; quoted '#'
    ("k: [{a: 1, b: 'p # q'}, []]  # trailing\n# whole-line\n",
     {"k": [{"a": "1", "b": "p # q"}, []]}),
    # sequence at the key's own indent, empty value, double-quoted escapes
    ('s:\n- 1\n- 2\nn:\nq: "a\\"b"\n',
     {"s": ["1", "2"], "n": "", "q": 'a"b'}),
])
def test_yaml_subset_structure(text, expected):
    from tpu_ray_tracer.models import yaml_subset as ys

    def plain(node):
        if isinstance(node, ys.ScalarNode):
            return node.value
        if isinstance(node, ys.SequenceNode):
            return [plain(c) for c in node.value]
        return {k.value: plain(v) for k, v in node.value}

    assert plain(ys.compose(text)) == expected


def test_yaml_subset_marks():
    """0-based marks as PyYAML's compose gives them: a value node starts at
    its first character, a sequence item's mapping at its first key."""
    from tpu_ray_tracer.models import yaml_subset as ys

    root = ys.compose("w: 5\nobjects:\n  - {type: sphere}\n  - type: plane\n")
    assert root.start_mark == (0, 0)
    (_, w), (_, objs) = root.value
    assert w.start_mark == (0, 3)
    assert objs.start_mark == (2, 2)
    assert objs.value[0].start_mark == (2, 4)
    assert objs.value[1].start_mark == (3, 4)
    assert objs.value[1].value[0][1].start_mark == (3, 10)


@pytest.mark.parametrize("text", [
    "a: [1, 2",          # unterminated flow sequence
    "a: {b: 1",          # unterminated flow mapping
    "a: [1] x",          # text after a flow value
    "  a: 1\n b: 2",     # bad dedent
    "a: 'open",          # unterminated quote
])
def test_yaml_subset_errors(text):
    with pytest.raises(SceneError, match="YAML parser error"):
        trt.load_from_string(text)
