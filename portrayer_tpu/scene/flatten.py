"""Lower a hierarchical Scene to flat device tables.

The analogue of the reference's FlatScene pass (src/flat_scene.rs:18-46): a
BFS over the node tree composing transforms (parent @ node), dropping
geometry-less nodes and duplicating instanced *nodes* — while keeping mesh
*triangle data* shared between instances.  The result is a pytree of jnp
arrays (SoA), grouped contiguously by primitive kind so the intersection
sweep can run one vectorized kernel per kind.

Every node carries: world->local affine, local->world affine, the normal
matrix (inv-transpose 3x3, src/scene.rs:204), material id, and — for meshes —
a (tri_start, tri_count) range into the shared triangle soup.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import math3d as m3
from .node import Scene, SceneNode, Sphere, Plane, Cube, Cylinder, Cone, Torus
from .mesh import Mesh, Triangle, Shading
from .texture import Texture, ImageTexture, NormalMap

# Primitive kind codes (order = group order in the tables).
SPHERE, PLANE, CUBE, CYLINDER, CONE, MESH, TORUS = range(7)
KIND_NAMES = ("sphere", "plane", "cube", "cylinder", "cone", "mesh", "torus")


def _static():
    """A SceneTables field that jit treats as static metadata (not traced)."""
    return dataclasses.field(metadata={"static": True})


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneTables:
    # --- per-node (grouped by kind) ---
    trans: jnp.ndarray        # [N,3,4] local->world
    inv: jnp.ndarray          # [N,3,4] world->local
    normal_mat: jnp.ndarray   # [N,3,3]
    material_id: jnp.ndarray  # [N] int32
    prim_params: jnp.ndarray  # [N,2] per-primitive params (torus radii)
    mesh_range: jnp.ndarray   # [N,2] int32 (tri_start, tri_count); zeros if not mesh
    aabb_min: jnp.ndarray     # [N,3] world-space AABB (8-corner transform,
    aabb_max: jnp.ndarray     # [N,3]  src/bounding_box.rs:123-148)
    # --- mesh triangle soup (shared across instances) ---
    tri_a: jnp.ndarray        # [T,3]
    tri_b: jnp.ndarray        # [T,3]
    tri_c: jnp.ndarray        # [T,3]
    tri_na: jnp.ndarray       # [T,3] vertex normals (zeros when flat)
    tri_nb: jnp.ndarray       # [T,3]
    tri_nc: jnp.ndarray       # [T,3]
    tri_smooth: jnp.ndarray   # [T] bool — interpolate vertex normals
    tri_uva: jnp.ndarray      # [T,2]
    tri_uvb: jnp.ndarray      # [T,2]
    tri_uvc: jnp.ndarray      # [T,2]
    tri_has_uv: jnp.ndarray   # [T] bool
    # instance-triangle pair lists for the brute-force sweep
    pair_node: jnp.ndarray    # [P] int32 node id
    pair_tri: jnp.ndarray     # [P] int32 tri id
    pair_aabb_min: jnp.ndarray  # [P,3] world AABB of the transformed triangle
    pair_aabb_max: jnp.ndarray  # [P,3]
    # --- materials ---
    mat_diffuse: jnp.ndarray       # [M,3]
    mat_specular: jnp.ndarray      # [M,3]
    mat_shininess: jnp.ndarray     # [M]
    mat_reflectivity: jnp.ndarray  # [M]
    mat_glossy: jnp.ndarray        # [M]
    mat_refraction: jnp.ndarray    # [M]
    mat_uv_trans: jnp.ndarray      # [M,3,3]
    mat_tex_id: jnp.ndarray        # [M] int32: -1 none; >=0 image; <=-2 fn id -(v+2)
    mat_normal_map_id: jnp.ndarray # [M] int32: -1 none
    # --- lights ---
    light_pos: jnp.ndarray     # [L,3]
    light_color: jnp.ndarray   # [L,3]
    light_falloff: jnp.ndarray # [L,3] (c0,c1,c2)
    light_area_a: jnp.ndarray  # [L,3]
    light_area_b: jnp.ndarray  # [L,3]
    light_is_area: jnp.ndarray # [L] bool
    ambient: jnp.ndarray       # [3]
    # --- texture atlases ---
    tex_data: jnp.ndarray      # [Ptex,3] uint8 sRGB texels (LUT-decoded)
    tex_meta: jnp.ndarray      # [K,3] int32 (offset, width, height)
    nm_data: jnp.ndarray       # [Pnm,3] uint8 normal-map texels
    nm_meta: jnp.ndarray       # [Knm,3] int32
    # --- static metadata (not traced) ---
    groups: Tuple[Tuple[int, int, int], ...] = _static()
    fn_textures: Tuple[Callable, ...] = _static()
    n_lights: int = _static()
    # Per-light static flag: parallelogram area light (soft shadows)?
    area_flags: Tuple[bool, ...] = _static()
    # Does any material reflect/refract?  (statically gates bounce rounds)
    any_reflective: bool = _static()
    any_refractive: bool = _static()
    # Does any material use glossy reflection / textures / normal maps?
    any_glossy: bool = _static()
    any_image_tex: bool = _static()
    any_normal_map: bool = _static()

    @property
    def n_nodes(self) -> int:
        return self.trans.shape[0]

    @property
    def n_pairs(self) -> int:
        return self.pair_node.shape[0]

    def replace(self, **updates) -> "SceneTables":
        """A copy with the given fields replaced (e.g. swapped parameters)."""
        return dataclasses.replace(self, **updates)

    def group(self, kind: int) -> Tuple[int, int]:
        for k, start, count in self.groups:
            if k == kind:
                return start, count
        return 0, 0


@dataclasses.dataclass
class _FlatNode:
    kind: int
    trans: np.ndarray  # 4x4
    material: Any
    tri_range: Tuple[int, int] = (0, 0)
    local_min: np.ndarray = None
    local_max: np.ndarray = None
    params: Tuple[float, float] = (0.0, 0.0)  # torus (center_r, tube_r)


# Local-space bounds per primitive kind (src/primitive/*.rs Bounds impls).
_LOCAL_BOUNDS = {
    SPHERE: (np.full(3, -1.0), np.full(3, 1.0)),
    PLANE: (np.array([-0.5, 0.0, -0.5]), np.array([0.5, 0.0, 0.5])),
    CUBE: (np.full(3, -0.5), np.full(3, 0.5)),
    CYLINDER: (np.array([-0.5, -0.5, -0.5]), np.array([0.5, 0.5, 0.5])),
    CONE: (np.array([-0.5, -0.5, -0.5]), np.array([0.5, 0.5, 0.5])),
}


def _world_aabb(trans4, lmin, lmax):
    corners = np.array(
        [[x, y, z] for x in (lmin[0], lmax[0]) for y in (lmin[1], lmax[1]) for z in (lmin[2], lmax[2])]
    )
    world = corners @ trans4[:3, :3].T + trans4[:3, 3]
    return world.min(axis=0), world.max(axis=0)


def flatten_scene(scene: Scene, dtype=jnp.float32) -> SceneTables:
    flat: List[_FlatNode] = []

    # Triangle soup accumulators (numpy blocks; mesh data shared between
    # instances gets one block, keyed by (data identity, shading)).
    tri_blocks: List[Dict[str, np.ndarray]] = []
    tri_total = 0
    tri_range_cache: Dict[Tuple[int, Any], Tuple[int, int]] = {}

    def _push_block(a, b, c, na, nb, nc, uva, uvb, uvc, smooth, has_uv):
        nonlocal tri_total
        K = len(a)
        tri_blocks.append({
            "tri_a": a, "tri_b": b, "tri_c": c,
            "tri_na": na, "tri_nb": nb, "tri_nc": nc,
            "tri_uva": uva, "tri_uvb": uvb, "tri_uvc": uvc,
            "tri_smooth": np.full(K, smooth, bool),
            "tri_has_uv": np.full(K, has_uv, bool),
        })
        rng = (tri_total, K)
        tri_total += K
        return rng

    def mesh_tri_range(mesh: Mesh) -> Tuple[int, int]:
        key = (id(mesh.data), mesh.shading)
        if key in tri_range_cache:
            return tri_range_cache[key]
        d = mesh.data
        t = np.asarray(d.triangles, np.int64).reshape(-1, 3)
        K = len(t)
        smooth = mesh.shading == Shading.Smooth
        has_uv = len(d.tex_coords) > 0
        z3 = np.zeros((K, 3))
        z2 = np.zeros((K, 2))
        rng = _push_block(
            d.positions[t[:, 0]], d.positions[t[:, 1]], d.positions[t[:, 2]],
            d.normals[t[:, 0]] if smooth else z3,
            d.normals[t[:, 1]] if smooth else z3,
            d.normals[t[:, 2]] if smooth else z3,
            d.tex_coords[t[:, 0]] if has_uv else z2,
            d.tex_coords[t[:, 1]] if has_uv else z2,
            d.tex_coords[t[:, 2]] if has_uv else z2,
            smooth, has_uv,
        )
        tri_range_cache[key] = rng
        return rng

    def triangle_tri_range(tri: Triangle) -> Tuple[int, int]:
        smooth = tri.normals is not None
        has_uv = tri.tex_coords is not None
        z3 = (np.zeros(3), np.zeros(3), np.zeros(3))
        z2 = (np.zeros(2), np.zeros(2), np.zeros(2))
        n = tri.normals if smooth else z3
        t = tri.tex_coords if has_uv else z2
        row = lambda x: np.asarray(x, np.float64)[None]
        return _push_block(
            row(tri.a), row(tri.b), row(tri.c),
            row(n[0]), row(n[1]), row(n[2]),
            row(t[0]), row(t[1]), row(t[2]),
            smooth, has_uv,
        )

    # BFS flatten, composing transforms (flat_scene.rs:27-40).
    queue: List[Tuple[np.ndarray, SceneNode]] = [(m3.identity4(), scene.root)]
    while queue:
        parent_trans, node = queue.pop(0)
        total = parent_trans @ node.trans
        if node.geometry is not None:
            prim = node.geometry.primitive
            mat = node.geometry.material
            if isinstance(prim, Sphere):
                flat.append(_FlatNode(SPHERE, total, mat))
            elif isinstance(prim, Plane):
                flat.append(_FlatNode(PLANE, total, mat))
            elif isinstance(prim, Cube):
                flat.append(_FlatNode(CUBE, total, mat))
            elif isinstance(prim, Cylinder):
                flat.append(_FlatNode(CYLINDER, total, mat))
            elif isinstance(prim, Cone):
                flat.append(_FlatNode(CONE, total, mat))
            elif isinstance(prim, Torus):
                cr, tr = prim.center_radius, prim.tube_radius
                r_out = cr + tr
                flat.append(_FlatNode(
                    TORUS, total, mat,
                    local_min=np.array([-r_out, -tr, -r_out]),
                    local_max=np.array([r_out, tr, r_out]),
                    params=(cr, tr),
                ))
            elif isinstance(prim, Mesh):
                rng = mesh_tri_range(prim)
                flat.append(
                    _FlatNode(
                        MESH, total, mat, rng,
                        prim.data.bounds_min, prim.data.bounds_max,
                    )
                )
            elif isinstance(prim, Triangle):
                rng = triangle_tri_range(prim)
                verts = np.stack([prim.a, prim.b, prim.c])
                flat.append(
                    _FlatNode(
                        MESH, total, mat, rng,
                        verts.min(axis=0), verts.max(axis=0),
                    )
                )
            else:
                raise TypeError(f"Unsupported primitive: {prim!r}")
        for child in node.children:
            queue.append((total, child))

    # Group nodes by kind (stable within kind = BFS order).
    flat.sort(key=lambda fn_: fn_.kind)
    groups = []
    start = 0
    for kind in range(7):
        count = sum(1 for f in flat if f.kind == kind)
        if count:
            groups.append((kind, start, count))
        start += count

    # Materials / textures / normal maps: unique by identity.
    materials: List[Any] = []
    mat_index: Dict[int, int] = {}
    for f in flat:
        if id(f.material) not in mat_index:
            mat_index[id(f.material)] = len(materials)
            materials.append(f.material)

    image_textures: List[ImageTexture] = []
    img_index: Dict[int, int] = {}
    fn_textures: List[Callable] = []
    fn_index: Dict[int, int] = {}
    normal_maps: List[NormalMap] = []
    nm_index: Dict[int, int] = {}

    def tex_code(tex) -> int:
        if tex is None:
            return -1
        if not isinstance(tex, Texture):
            tex = Texture(tex)
        if tex.is_image:
            img = tex.image
            if id(img) not in img_index:
                img_index[id(img)] = len(image_textures)
                image_textures.append(img)
            return img_index[id(img)]
        fn = tex.fn
        if id(fn) not in fn_index:
            fn_index[id(fn)] = len(fn_textures)
            fn_textures.append(fn)
        return -(fn_index[id(fn)] + 2)

    def nm_code(nm) -> int:
        if nm is None:
            return -1
        if id(nm) not in nm_index:
            nm_index[id(nm)] = len(normal_maps)
            normal_maps.append(nm)
        return nm_index[id(nm)]

    M = max(len(materials), 1)
    mat_diffuse = np.zeros((M, 3))
    mat_specular = np.zeros((M, 3))
    mat_shininess = np.zeros(M)
    mat_reflectivity = np.zeros(M)
    mat_glossy = np.zeros(M)
    mat_refraction = np.zeros(M)
    mat_uv_trans = np.tile(np.eye(3), (M, 1, 1))
    mat_tex_id = np.full(M, -1, dtype=np.int32)
    mat_nm_id = np.full(M, -1, dtype=np.int32)
    for i, m in enumerate(materials):
        mat_diffuse[i] = m.diffuse
        mat_specular[i] = m.specular
        mat_shininess[i] = m.shininess
        mat_reflectivity[i] = m.reflectivity
        mat_glossy[i] = m.glossy_side_length
        mat_refraction[i] = m.refraction_index
        if m.uv_trans is not None:
            mat_uv_trans[i] = m.uv_trans
        mat_tex_id[i] = tex_code(m.texture)
        mat_nm_id[i] = nm_code(m.normals)

    # Triangle arrays (block concat).
    if tri_blocks:
        tri = {
            k: np.concatenate([blk[k] for blk in tri_blocks], axis=0)
            for k in tri_blocks[0]
        }
    else:
        tri = {
            "tri_a": np.zeros((1, 3)), "tri_b": np.zeros((1, 3)),
            "tri_c": np.zeros((1, 3)),
            "tri_na": np.zeros((1, 3)), "tri_nb": np.zeros((1, 3)),
            "tri_nc": np.zeros((1, 3)),
            "tri_uva": np.zeros((1, 2)), "tri_uvb": np.zeros((1, 2)),
            "tri_uvc": np.zeros((1, 2)),
            "tri_smooth": np.zeros(1, bool), "tri_has_uv": np.zeros(1, bool),
        }

    # Node tables — batched numpy (the reference's per-node cached matrices,
    # flat_scene.rs:50-131, computed for all nodes at once).
    N = max(len(flat), 1)
    if flat:
        t4 = np.stack([f.trans for f in flat])            # [N,4,4]
        inv4 = np.linalg.inv(t4)
        trans = t4[:, :3, :4].copy()
        inv = inv4[:, :3, :4].copy()
        normal_mat = np.linalg.inv(t4[:, :3, :3]).transpose(0, 2, 1).copy()
        material_id = np.asarray(
            [mat_index[id(f.material)] for f in flat], np.int32
        )
        prim_params = np.asarray([f.params for f in flat], np.float64)
        mesh_range = np.asarray(
            [f.tri_range if f.kind == MESH else (0, 0) for f in flat],
            np.int32,
        )
        lmin = np.stack([
            f.local_min if f.kind in (MESH, TORUS) else _LOCAL_BOUNDS[f.kind][0]
            for f in flat
        ])
        lmax = np.stack([
            f.local_max if f.kind in (MESH, TORUS) else _LOCAL_BOUNDS[f.kind][1]
            for f in flat
        ])
        # World AABB via all 8 transformed corners (bounding_box.rs:123-148).
        world_min = np.full((N, 3), np.inf)
        world_max = np.full((N, 3), -np.inf)
        for ci in range(8):
            sel = np.array([(ci >> 2) & 1, (ci >> 1) & 1, ci & 1], bool)
            corner = np.where(sel, lmax, lmin)            # [N,3]
            w = np.einsum("nij,nj->ni", t4[:, :3, :3], corner) + t4[:, :3, 3]
            world_min = np.minimum(world_min, w)
            world_max = np.maximum(world_max, w)
        aabb_min, aabb_max = world_min, world_max
    else:
        trans = np.tile(np.eye(3, 4), (N, 1, 1))
        inv = np.tile(np.eye(3, 4), (N, 1, 1))
        normal_mat = np.tile(np.eye(3), (N, 1, 1))
        material_id = np.zeros(N, np.int32)
        prim_params = np.zeros((N, 2))
        mesh_range = np.zeros((N, 2), np.int32)
        aabb_min = np.zeros((N, 3))
        aabb_max = np.zeros((N, 3))

    # Instance-triangle pairs — batched (instanced meshes duplicate pairs,
    # not triangle data).
    mesh_ids = np.asarray(
        [i for i, f in enumerate(flat) if f.kind == MESH], np.int64
    )
    if mesh_ids.size:
        starts = np.asarray([flat[i].tri_range[0] for i in mesh_ids])
        counts = np.asarray([flat[i].tri_range[1] for i in mesh_ids])
        pair_node = np.repeat(mesh_ids, counts).astype(np.int64)
        pair_tri = np.concatenate(
            [np.arange(s, s + c) for s, c in zip(starts, counts)]
        ).astype(np.int64)
        verts3 = np.stack(
            [tri["tri_a"][pair_tri], tri["tri_b"][pair_tri],
             tri["tri_c"][pair_tri]], axis=1,
        )                                                  # [P,3,3]
        rot = t4[pair_node][:, :3, :3]
        off = t4[pair_node][:, :3, 3]
        world = np.einsum("pij,pkj->pki", rot, verts3) + off[:, None, :]
        pair_amin = world.min(axis=1)
        pair_amax = world.max(axis=1)
    else:
        pair_node = np.zeros((0,), np.int64)
        pair_tri = np.zeros((0,), np.int64)
        pair_amin = np.zeros((0, 3))
        pair_amax = np.zeros((0, 3))

    # Lights.
    L = max(len(scene.lights), 1)
    light_pos = np.zeros((L, 3))
    light_color = np.zeros((L, 3))
    light_falloff = np.tile(np.array([1.0, 0.0, 0.0]), (L, 1))
    light_area_a = np.zeros((L, 3))
    light_area_b = np.zeros((L, 3))
    light_is_area = np.zeros(L, dtype=bool)
    for i, lt in enumerate(scene.lights):
        light_pos[i] = lt.position
        light_color[i] = lt.color
        light_falloff[i] = (lt.falloff.c0, lt.falloff.c1, lt.falloff.c2)
        light_area_a[i] = lt.area.a
        light_area_b[i] = lt.area.b
        light_is_area[i] = not lt.area.is_empty()

    # Texture atlases: uint8 texels (12x less HBM/transfer than prebaked
    # f32; the sRGB/normal decode is a 256-entry LUT at sample time, see
    # ops/shade.py — bit-identical to prebaking).
    def build_atlas(images: List):
        if not images:
            return np.zeros((1, 3), dtype=np.uint8), \
                np.zeros((1, 3), dtype=np.int32)
        metas, chunks, off = [], [], 0
        for img in images:
            data = img.raw
            h, w = data.shape[:2]
            metas.append((off, w, h))
            chunks.append(data.reshape(-1, 3))
            off += h * w
        return np.concatenate(chunks, axis=0), np.asarray(metas, dtype=np.int32)

    tex_data, tex_meta = build_atlas(image_textures)
    nm_data, nm_meta = build_atlas(normal_maps)

    f = lambda x: jnp.asarray(x, dtype=dtype)
    i32 = lambda x: jnp.asarray(x, dtype=jnp.int32)
    b8 = lambda x: jnp.asarray(x, dtype=jnp.bool_)

    return SceneTables(
        trans=f(trans), inv=f(inv), normal_mat=f(normal_mat),
        material_id=i32(material_id), prim_params=f(prim_params),
        mesh_range=i32(mesh_range),
        aabb_min=f(aabb_min), aabb_max=f(aabb_max),
        tri_a=f(tri["tri_a"]), tri_b=f(tri["tri_b"]), tri_c=f(tri["tri_c"]),
        tri_na=f(tri["tri_na"]), tri_nb=f(tri["tri_nb"]), tri_nc=f(tri["tri_nc"]),
        tri_smooth=b8(tri["tri_smooth"]),
        tri_uva=f(tri["tri_uva"]), tri_uvb=f(tri["tri_uvb"]), tri_uvc=f(tri["tri_uvc"]),
        tri_has_uv=b8(tri["tri_has_uv"]),
        pair_node=i32(pair_node if pair_node.size else [0]),
        pair_tri=i32(pair_tri if pair_tri.size else [0]),
        pair_aabb_min=f(pair_amin if pair_amin.size else np.zeros((1, 3))),
        pair_aabb_max=f(pair_amax if pair_amax.size else np.zeros((1, 3))),
        mat_diffuse=f(mat_diffuse), mat_specular=f(mat_specular),
        mat_shininess=f(mat_shininess), mat_reflectivity=f(mat_reflectivity),
        mat_glossy=f(mat_glossy), mat_refraction=f(mat_refraction),
        mat_uv_trans=f(mat_uv_trans), mat_tex_id=i32(mat_tex_id),
        mat_normal_map_id=i32(mat_nm_id),
        light_pos=f(light_pos), light_color=f(light_color),
        light_falloff=f(light_falloff),
        light_area_a=f(light_area_a), light_area_b=f(light_area_b),
        light_is_area=b8(light_is_area),
        ambient=f(scene.ambient),
        tex_data=jnp.asarray(tex_data, jnp.uint8), tex_meta=i32(tex_meta),
        nm_data=jnp.asarray(nm_data, jnp.uint8), nm_meta=i32(nm_meta),
        groups=tuple(groups),
        fn_textures=tuple(fn_textures),
        n_lights=len(scene.lights),
        area_flags=tuple(not lt.area.is_empty() for lt in scene.lights),
        any_reflective=any(m.reflectivity > 0.0 for m in materials),
        any_refractive=any(
            m.reflectivity > 0.0 and m.refraction_index > 0.0 for m in materials
        ),
        any_glossy=any(
            m.reflectivity > 0.0 and m.glossy_side_length > 0.0 for m in materials
        ),
        any_image_tex=len(image_textures) > 0,
        any_normal_map=len(normal_maps) > 0,
    )


# ---------------------------------------------------------------------------
# Fused shading records — built with jnp ops from the traced tables so that
# reverse-mode AD flows to the material/light parameters, then gathered by
# ONE row gather per ray (the fused record is the difference between ~11
# gathers and 1 in hit_detail/shade; what a gather costs on the GPU is not
# measured yet).
# ---------------------------------------------------------------------------

# node_record column layout:
#   0..11  world->local affine (row-major 3x4); the normal matrix is its
#          transposed 3x3 rotation (scene.rs:204), not stored.
#   12..14 diffuse  15..17 specular  18 shininess  19 reflectivity
#   20 glossy_side_length  21 refraction_index
#   22 tex_id  23 normal_map_id  24 material_id   (float-encoded ints)
#   25..30 uv_trans rows 0..1 (m00 m01 m02 m10 m11 m12)
#   31 primitive kind   32..33 primitive params (torus radii)
REC_INV = slice(0, 12)
REC_DIFFUSE = slice(12, 15)
REC_SPECULAR = slice(15, 18)
REC_SHININESS = 18
REC_REFLECTIVITY = 19
REC_GLOSSY = 20
REC_REFRACTION = 21
REC_TEX_ID = 22
REC_NM_ID = 23
REC_MATERIAL = 24
REC_UV_TRANS = slice(25, 31)
REC_KIND = 31
REC_PARAMS = slice(32, 34)


def node_record(st: "SceneTables") -> jnp.ndarray:
    """[N,34] fused per-node shading record (differentiable)."""
    N = st.n_nodes
    dt = st.inv.dtype
    mid = st.material_id
    kinds = np.zeros(N, np.int32)
    for kind, start, count in st.groups:
        kinds[start:start + count] = kind
    col = lambda x: x[:, None].astype(dt)
    return jnp.concatenate(
        [
            st.inv.reshape(N, 12),
            st.mat_diffuse[mid],
            st.mat_specular[mid],
            col(st.mat_shininess[mid]),
            col(st.mat_reflectivity[mid]),
            col(st.mat_glossy[mid]),
            col(st.mat_refraction[mid]),
            col(st.mat_tex_id[mid]),
            col(st.mat_normal_map_id[mid]),
            col(mid),
            st.mat_uv_trans[mid][:, :2, :].reshape(N, 6),
            jnp.asarray(kinds[:, None], dt),
            st.prim_params,
        ],
        axis=1,
    )


# tri_record column layout:
#   0..8 a,b,c   9..17 na,nb,nc   18..23 uva,uvb,uvc   24 smooth  25 has_uv
def tri_record(st: "SceneTables") -> jnp.ndarray:
    """[T,26] fused per-triangle detail record (differentiable)."""
    dt = st.tri_a.dtype
    col = lambda x: x[:, None].astype(dt)
    return jnp.concatenate(
        [
            st.tri_a, st.tri_b, st.tri_c,
            st.tri_na, st.tri_nb, st.tri_nc,
            st.tri_uva, st.tri_uvb, st.tri_uvc,
            col(st.tri_smooth), col(st.tri_has_uv),
        ],
        axis=1,
    )
