"""Vector/matrix math for the renderer.

The reference keeps scalar f64 vek types (src/math.rs:22-33).  Here everything
is SoA: points/directions are arrays of shape [..., 3], affine transforms are
[..., 3, 4] (rotation|translation), and all ops broadcast.  Host-side scene
construction uses numpy float64 (matching the reference's precision for
transform composition/inversion); device code uses the configured dtype.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Batched jnp vector helpers (device side)
# ---------------------------------------------------------------------------

def dot(a, b):
    """Dot product over the last axis, keeping batch dims ([...,3] -> [...])."""
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def safe_sqrt(x, tiny=1e-30):
    """sqrt(max(x, 0)) with a finite reverse mode at x <= 0.

    sqrt'(0) = inf, and jnp.maximum's transpose *multiplies* the incoming
    cotangent by an indicator rather than selecting, so even a zero
    cotangent turns into 0 * inf = NaN and poisons whole parameter
    gradients.  Clamping the argument to `tiny` keeps the derivative
    finite; the trailing where restores the exact forward value at x <= 0.
    """
    return jnp.where(x > 0.0, jnp.sqrt(jnp.maximum(x, tiny)), 0.0)


def norm(v, eps=0.0):
    """|v|.  With eps, clamps |v|^2 to eps^2 *before* the sqrt so reverse
    mode stays finite at v = 0 (sqrt'(0) = inf would otherwise turn a
    masked-out lane's zero cotangent into 0 * inf = NaN).

    The clamp is floored at the smallest *normal* float32: eps = 1e-30
    squares to 1e-60 which underflows to 0.0 in f32 (and accelerators may
    flush subnormals), silently disabling the guard — normalize(zero_vector)
    then returns 0/0 = NaN.  This was the round-2 flagship NaN: castle
    triangles with degenerate UVs (uva == uvb) produce an exactly-zero
    bitangent, and the unguarded normalize poisoned the TBN and every
    normal-mapped shade downstream."""
    s = dot(v, v)
    if eps:
        s = jnp.maximum(s, max(eps * eps, 1.2e-38))
    return jnp.sqrt(s)


def normalize(v, eps=0.0):
    return v / norm(v, eps=eps)[..., None]


# NOTE: these small transforms deliberately use explicit elementwise
# arithmetic instead of einsum/dot.  On an H100 an f32 dot may run in TF32
# (about three decimal digits), which manifests as shadow acne; elementwise
# mul+add stays in full float32, and at 3x3/3x4 sizes a matrix unit has
# nothing to gain.

def transform_point(m34, p):
    """Apply affine [...,3,4] to points [...,3]."""
    return (
        jnp.sum(m34[..., :, :3] * p[..., None, :], axis=-1) + m34[..., :, 3]
    )


def transform_dir(m34, d):
    """Apply the linear part of affine [...,3,4] to directions [...,3]."""
    return jnp.sum(m34[..., :, :3] * d[..., None, :], axis=-1)


def matvec3(m33, v):
    return jnp.sum(m33 * v[..., None, :], axis=-1)


# ---------------------------------------------------------------------------
# Host-side (numpy f64) transform builders — the scene-graph math
# ---------------------------------------------------------------------------

def identity4() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def translation(v) -> np.ndarray:
    m = identity4()
    m[:3, 3] = np.asarray(v, dtype=np.float64)
    return m


def scaling(v) -> np.ndarray:
    v = np.asarray(v, dtype=np.float64)
    if v.ndim == 0:
        v = np.full(3, float(v))
    m = identity4()
    m[0, 0], m[1, 1], m[2, 2] = v
    return m


def rotation_x(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = identity4()
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def rotation_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = identity4()
    m[0, 0], m[0, 2] = c, s
    m[2, 0], m[2, 2] = -s, c
    return m


def rotation_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = identity4()
    m[0, 0], m[0, 1] = c, -s
    m[1, 0], m[1, 1] = s, c
    return m


def look_at_rh(eye, center, up) -> np.ndarray:
    """World-to-view matrix (same convention as vek's Mat4::look_at_rh).

    Used by the camera (src/camera.rs:38), which inverts it to get
    view-to-world.
    """
    eye = np.asarray(eye, dtype=np.float64)
    center = np.asarray(center, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = identity4()
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[:3, 3] = -m[:3, :3] @ eye
    return m


def invert(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(m)


def to_affine34(m: np.ndarray) -> np.ndarray:
    """Take the top 3x4 of a 4x4 (we only ever use affine transforms)."""
    return np.asarray(m, dtype=np.float64)[:3, :4]


def normal_matrix(m: np.ndarray) -> np.ndarray:
    """inverse-transpose 3x3, the reference's normal_trans (src/scene.rs:204).

    vek applies the full Mat4 to a w=0 vector, which uses only the upper-left
    3x3 of invtrans.transposed().
    """
    return np.linalg.inv(m[:3, :3]).T


def radians(deg: float) -> float:
    return float(np.deg2rad(deg))


# ---------------------------------------------------------------------------
# Quadratic solver — parity with roots::find_roots_quadratic semantics
# (src/math.rs:107-114): roots sorted ascending; linear fallback when a == 0.
# ---------------------------------------------------------------------------

def quadratic_roots(a, b, c):
    """Return (r0, r1, num_roots) with r0 <= r1; num_roots in {0, 1, 2}.

    Invalid roots are +inf.  Matches the roots crate: exact a == 0 falls back
    to the linear equation; disc == 0 gives a double root.
    """
    disc = b * b - 4.0 * a * c
    sq = safe_sqrt(disc)
    # Numerically stable: q = -(b + sign(b)*sq)/2; roots q/a and c/q.
    sgn = jnp.where(b >= 0.0, 1.0, -1.0)
    q = -0.5 * (b + sgn * sq)
    safe_a = jnp.where(a == 0.0, 1.0, a)
    safe_q = jnp.where(q == 0.0, 1.0, q)
    ra = jnp.where(a == 0.0, jnp.inf, q / safe_a)
    rb = jnp.where(q == 0.0, -b / (2.0 * safe_a), c / safe_q)
    r0 = jnp.minimum(ra, rb)
    r1 = jnp.maximum(ra, rb)
    # Linear fallback: a == 0 -> bt + c = 0.
    safe_b = jnp.where(b == 0.0, 1.0, b)
    lin = jnp.where(b == 0.0, jnp.inf, -c / safe_b)
    quad_ok = (a != 0.0) & (disc >= 0.0)
    r0 = jnp.where(a == 0.0, lin, jnp.where(quad_ok, r0, jnp.inf))
    r1 = jnp.where(a == 0.0, jnp.inf, jnp.where(quad_ok, r1, jnp.inf))
    return r0, r1


def smallest_root_in_range(a, b, c, t_min, t_max):
    """Smallest quadratic root t with t_min <= t < t_max (Solutions::
    find_in_range, src/math.rs:94-96).  Returns (t, valid)."""
    r0, r1 = quadratic_roots(a, b, c)
    ok0 = (r0 >= t_min) & (r0 < t_max)
    ok1 = (r1 >= t_min) & (r1 < t_max)
    t = jnp.where(ok0, r0, jnp.where(ok1, r1, jnp.inf))
    return t, ok0 | ok1


# ---------------------------------------------------------------------------
# Quartic solver — the analogue of the reference's Quartic wrapper over the
# roots crate (src/math.rs:126-133), used by the torus (primitive/torus.rs).
# Ferrari's method via the resolvent cubic, followed by Newton polish so the
# roots are usable in float32.
# ---------------------------------------------------------------------------

def _solve_cubic_largest(a2, a1, a0):
    """Largest real root of z^3 + a2 z^2 + a1 z + a0 (trigonometric form)."""
    p = a1 - a2 * a2 / 3.0
    q = 2.0 * a2 ** 3 / 27.0 - a2 * a1 / 3.0 + a0
    # Discriminant split: three real roots (trig) vs one (Cardano).
    half_q = q / 2.0
    third_p = p / 3.0
    disc = half_q * half_q + third_p ** 3
    # Trig branch (disc <= 0): z = 2 sqrt(-p/3) cos(phi/3) - a2/3.
    safe_tp = jnp.minimum(third_p, -1e-30)
    m = 2.0 * jnp.sqrt(-safe_tp)
    cos_arg = jnp.clip(3.0 * q / (p * jnp.where(p == 0.0, 1.0, m)), -1.0, 1.0)
    phi = jnp.arccos(cos_arg)
    z_trig = m * jnp.cos(phi / 3.0) - a2 / 3.0
    # Cardano branch (disc > 0): one real root.
    sq = safe_sqrt(disc)
    u = jnp.cbrt(-half_q + sq)
    v = jnp.cbrt(-half_q - sq)
    z_card = u + v - a2 / 3.0
    return jnp.where(disc > 0.0, z_card, z_trig)


def quartic_roots(A, B, C, D, E):
    """Real roots of A t^4 + B t^3 + C t^2 + D t + E (A != 0).

    Returns (roots[..., 4], valid[..., 4]); invalid entries are +inf.
    Roots are Newton-polished (3 iterations) for float32 robustness.
    """
    safe_A = jnp.where(A == 0.0, 1.0, A)
    b = B / safe_A
    c = C / safe_A
    d = D / safe_A
    e = E / safe_A
    # Depressed quartic u^4 + p u^2 + q u + r with t = u - b/4.
    b2 = b * b
    p = c - 3.0 * b2 / 8.0
    q = d - b * c / 2.0 + b2 * b / 8.0
    r = e - b * d / 4.0 + b2 * c / 16.0 - 3.0 * b2 * b2 / 256.0

    # Resolvent cubic z^3 + 2p z^2 + (p^2 - 4r) z - q^2 = 0; any root z > 0
    # factors the quartic into two quadratics.
    a2c = 2.0 * p
    a1c = p * p - 4.0 * r
    a0c = -q * q
    z = _solve_cubic_largest(a2c, a1c, a0c)
    # Newton-polish z: Cardano cancels badly near q ~ 0 (symmetric quartics),
    # leaving z off by ~1e-3 and pushing Ferrari's factors complex.
    for _ in range(2):
        fz = ((z + a2c) * z + a1c) * z + a0c
        fpz = (3.0 * z + 2.0 * a2c) * z + a1c
        z = z - fz / jnp.where(fpz == 0.0, 1.0, fpz)
    z = jnp.maximum(z, 0.0)
    s = safe_sqrt(z)
    # Biquadratic fallback when q ~ 0 (scale-relative: z ~ t^2 sized by |p|).
    biquad = z < 1e-6 * (1.0 + jnp.abs(p))
    s_safe = jnp.where(biquad, 1.0, s)

    # u^2 + s u + (p + z)/2 - q/(2s) = 0  and  u^2 - s u + (p + z)/2 + q/(2s)
    half = (p + z) / 2.0
    shift = q / (2.0 * s_safe)
    c1 = half - shift
    c2 = half + shift

    def quad(bq, cq):
        disc = bq * bq - 4.0 * cq
        ok = disc >= 0.0
        sqd = safe_sqrt(disc)
        return (-bq - sqd) / 2.0, (-bq + sqd) / 2.0, ok

    u1, u2, ok12 = quad(s, c1)
    u3, u4, ok34 = quad(-s, c2)

    # Biquadratic: y^2 + p y + r = 0; u = +-sqrt(y).
    ydisc = p * p - 4.0 * r
    ysq = safe_sqrt(ydisc)
    y1 = (-p - ysq) / 2.0
    y2 = (-p + ysq) / 2.0
    okb = ydisc >= 0.0
    bu1 = -safe_sqrt(y1)
    bu2 = safe_sqrt(y1)
    bu3 = -safe_sqrt(y2)
    bu4 = safe_sqrt(y2)
    okb1 = okb & (y1 >= 0.0)
    okb2 = okb & (y2 >= 0.0)

    u_all = jnp.stack([
        jnp.where(biquad, bu1, u1),
        jnp.where(biquad, bu2, u2),
        jnp.where(biquad, bu3, u3),
        jnp.where(biquad, bu4, u4),
    ], axis=-1)
    ok_all = jnp.stack([
        jnp.where(biquad, okb1, ok12),
        jnp.where(biquad, okb1, ok12),
        jnp.where(biquad, okb2, ok34),
        jnp.where(biquad, okb2, ok34),
    ], axis=-1)

    t = u_all - (b / 4.0)[..., None]

    # Newton polish on the original quartic (Horner), 3 iterations.
    for _ in range(3):
        f = (((A[..., None] * t + B[..., None]) * t + C[..., None]) * t
             + D[..., None]) * t + E[..., None]
        fp = ((4.0 * A[..., None] * t + 3.0 * B[..., None]) * t
              + 2.0 * C[..., None]) * t + D[..., None]
        t = t - f / jnp.where(fp == 0.0, 1.0, fp)

    valid = ok_all & (A[..., None] != 0.0)
    return jnp.where(valid, t, jnp.inf), valid


def quartic_smallest_root_in_range(A, B, C, D, E, t_min, t_max):
    """Smallest real quartic root with t_min <= t < t_max
    (Solutions::find_in_range semantics, src/math.rs:94-96)."""
    roots, valid = quartic_roots(A, B, C, D, E)
    ok = valid & (roots >= t_min[..., None]) & (roots < t_max[..., None])
    t = jnp.min(jnp.where(ok, roots, jnp.inf), axis=-1)
    return t, jnp.any(ok, axis=-1)
