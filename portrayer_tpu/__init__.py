"""portrayer_tpu — a re-implementation of the `portrayer` recursive ray
tracer (reference: sunjay/portrayer) as a JAX/XLA wavefront pipeline for
an accelerator (an NVIDIA H100).

Feature parity with the reference library (SURVEY.md §2): analytic
primitives (sphere/cube/plane/cylinder/cone), triangle meshes with flat and
smooth shading + OBJ loading, hierarchical scenes with instancing, the full
Whitted lighting model (Blinn-Phong, shadows, mirror/glossy reflection,
Snell/Schlick refraction), textures (image + procedural) and normal maps,
point + parallelogram area lights with falloff, jittered supersampling,
gamma-encoded PNG output — all executed as SoA wavefront batches on the
device, sharded over device meshes for multi-card scaling, and
differentiable.
"""

from .config import (
    RenderConfig, EPSILON, GAMMA, MAX_RECURSION_DEPTH,
    AIR_REFRACTION_INDEX, WATER_REFRACTION_INDEX,
    WINDOW_GLASS_REFRACTION_INDEX, OPTICAL_GLASS_REFRACTION_INDEX,
    DIAMOND_REFRACTION_INDEX,
)
from .camera import Camera, CameraSettings
from .render import Image, render_linear, render_u8, finalize, to_u8
from .reporter import Reporter, RenderProgress, NullProgress
from .scene.node import (
    Scene, SceneNode, Geometry, Sphere, Cube, Plane, Cylinder, Cone, Torus,
)
from .scene.material import Material
from .scene.light import Light, Falloff, Parallelogram
from .scene.mesh import Mesh, KDMesh, MeshData, Shading, Triangle
from .scene.texture import Texture, ImageTexture, NormalMap
from .scene.flatten import flatten_scene, SceneTables
from . import math3d

__all__ = [
    "RenderConfig", "EPSILON", "GAMMA", "MAX_RECURSION_DEPTH",
    "AIR_REFRACTION_INDEX", "WATER_REFRACTION_INDEX",
    "WINDOW_GLASS_REFRACTION_INDEX", "OPTICAL_GLASS_REFRACTION_INDEX",
    "DIAMOND_REFRACTION_INDEX",
    "Camera", "CameraSettings",
    "Image", "render_linear", "render_u8", "finalize", "to_u8",
    "Reporter", "RenderProgress", "NullProgress",
    "Scene", "SceneNode", "Geometry",
    "Sphere", "Cube", "Plane", "Cylinder", "Cone", "Torus",
    "Material", "Light", "Falloff", "Parallelogram",
    "Mesh", "KDMesh", "MeshData", "Shading", "Triangle",
    "Texture", "ImageTexture", "NormalMap",
    "flatten_scene", "SceneTables",
    "math3d",
]
