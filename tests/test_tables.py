"""SceneTables as a plain JAX pytree (a frozen dataclass registered with
jax.tree_util): tree round trip, `replace`, and static metadata under jit;
and the package's independence from flax and PIL."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp

import scenes
from portrayer_tpu import flatten_scene
from portrayer_tpu.scene.flatten import SceneTables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATIC = ("groups", "fn_textures", "n_lights", "area_flags",
          "any_reflective", "any_refractive", "any_glossy", "any_image_tex",
          "any_normal_map")


def _tables():
    return flatten_scene(scenes.load("simple").scene, dtype=jnp.float32)


def test_scene_tables_tree_round_trip():
    st = _tables()
    leaves, treedef = jax.tree_util.tree_flatten(st)
    assert all(isinstance(x, jax.Array) for x in leaves)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(back, SceneTables)
    for name in STATIC:
        assert getattr(back, name) == getattr(st, name)
    for a, b in zip(leaves, jax.tree_util.tree_leaves(back)):
        assert a is b
    doubled = jax.tree_util.tree_map(lambda x: x * 2, st)
    np.testing.assert_array_equal(doubled.mat_diffuse, 2 * st.mat_diffuse)
    assert doubled.groups == st.groups


def test_scene_tables_replace():
    st = _tables()
    half = st.mat_diffuse * 0.5
    st2 = st.replace(mat_diffuse=half)
    assert st2 is not st and isinstance(st2, SceneTables)
    assert st2.mat_diffuse is half
    assert st.mat_diffuse is not half  # frozen original untouched
    assert st2.inv is st.inv and st2.groups is st.groups


def test_scene_tables_static_fields_under_jit():
    st = _tables()
    traces = []

    @jax.jit
    def f(st):
        traces.append(1)
        # Static fields are Python values while tracing.
        assert isinstance(st.n_lights, int) and isinstance(st.groups, tuple)
        return st.light_color[: st.n_lights].sum() * len(st.groups)

    expected = float(st.light_color[: st.n_lights].sum()) * len(st.groups)
    np.testing.assert_allclose(float(f(st)), expected, rtol=1e-6)
    f(st.replace(light_color=st.light_color * 2))  # same statics: cached
    assert len(traces) == 1
    f(st.replace(any_glossy=not st.any_glossy))   # new static: retrace
    assert len(traces) == 2


def test_render_and_save_without_flax_pil_or_native(tmp_path):
    """The package imports, renders and saves a PNG with flax and PIL
    unimportable and the native library disabled."""
    out = tmp_path / "simple.png"
    code = (
        "import sys; sys.modules['flax'] = None; sys.modules['PIL'] = None\n"
        "import portrayer_tpu, scenes\n"
        "from portrayer_tpu import Image, RenderConfig\n"
        "spec = scenes.load('simple')\n"
        f"img = Image({str(out)!r}, 24, 16)\n"
        "img.render(spec.scene, spec.camera, spec.background,\n"
        "           RenderConfig(samples=1, tile=(16, 16)))\n"
        "img.save()\n"
        "assert img.buffer.max() > 0\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               PORTRAYER_NO_NATIVE="1")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    from portrayer_tpu import png

    img = png.decode(out.read_bytes())
    assert img.shape == (16, 24, 3) and img.max() > 0
