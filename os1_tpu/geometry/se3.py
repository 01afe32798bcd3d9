"""SE(3) Lie-group operations as pure, vmappable JAX functions.

Replaces the reference's g2o manifold types (``VertexSE3Expmap`` /
``se3quat.h``, reference Thirdparty/g2o/g2o/types) with functional exp/log
maps so pose blocks can be optimized in batch on the device instead of
through a pointer-graph optimizer.

Conventions:
  * A rigid transform ``T`` is a (4, 4) row-major matrix ``[[R, t], [0, 1]]``.
  * World-to-camera is written ``Tcw`` (as in the reference, KeyFrame.cc:89-102).
  * Tangent vectors are (6,) arrays ``xi = [rho (3), phi (3)]`` — translation
    part first, rotation part second (matching g2o's se3quat ordering so that
    documented iteration counts/damping transfer).

All functions are jit-safe (no data-dependent python control flow) and
broadcast over leading batch dimensions where documented.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(phi: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(M: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return jnp.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], axis=-1)


def _safe_norm(v):
    """||v|| with a well-defined (zero) gradient at v = 0.

    jnp.linalg.norm's gradient is NaN at zero, which poisons jacfwd through
    exp() at the identity — exactly where optimizers linearize.
    """
    sq = jnp.sum(v * v, axis=-1)
    return jnp.sqrt(sq + 1e-37)


def _sinc(theta):
    """sin(theta)/theta with Taylor fallback near 0."""
    small = jnp.abs(theta) < 1e-4
    safe = jnp.where(small, 1.0, theta)
    return jnp.where(small, 1.0 - theta * theta / 6.0, jnp.sin(safe) / safe)


def _cosc(theta):
    """(1 - cos(theta)) / theta^2 with Taylor fallback near 0."""
    small = jnp.abs(theta) < 1e-4
    safe = jnp.where(small, 1.0, theta)
    return jnp.where(small, 0.5 - theta * theta / 24.0, (1.0 - jnp.cos(safe)) / (safe * safe))


def so3_exp(phi: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues formula: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta = _safe_norm(phi)
    K = hat(phi)
    K2 = K @ K
    a = _sinc(theta)[..., None, None]
    b = _cosc(theta)[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + a * K + b * K2


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Logarithm map (..., 3, 3) -> (..., 3). Valid for theta in [0, pi)."""
    trace = jnp.trace(R, axis1=-2, axis2=-1)
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    w = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5  # = sin(theta) * axis
    # phi = theta / sin(theta) * w ; near pi sin(theta) -> 0 so handle separately.
    sin_theta = jnp.sin(theta)
    near_pi = theta > 3.0
    factor = jnp.where(
        jnp.abs(sin_theta) < 1e-6, 1.0, theta / jnp.where(jnp.abs(sin_theta) < 1e-6, 1.0, sin_theta)
    )
    phi_generic = factor[..., None] * w
    # Near pi: use diagonal of R to recover axis magnitude.
    # R = I + sin(t) K + (1-cos t) K^2 ; diag(K^2) = -(y^2+z^2, ...), so
    # axis_i^2 = (R_ii - cos t) / (1 - cos t).
    one_minus_cos = jnp.clip(1.0 - cos_theta, 1e-8, None)
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis_sq = jnp.clip((diag - cos_theta[..., None]) / one_minus_cos[..., None], 0.0, None)
    axis_abs = jnp.sqrt(axis_sq)
    sign = jnp.where(w >= 0, 1.0, -1.0)
    phi_pi = theta[..., None] * axis_abs * sign
    return jnp.where(near_pi[..., None], phi_pi, phi_generic)


def _left_jacobian(phi: jnp.ndarray) -> jnp.ndarray:
    """SO(3) left Jacobian V: exp([rho;phi]) translation = V @ rho."""
    theta = _safe_norm(phi)
    K = hat(phi)
    K2 = K @ K
    small = theta < 1e-4
    safe = jnp.where(small, 1.0, theta)
    b = _cosc(theta)  # (1-cos)/t^2
    c = jnp.where(
        small, 1.0 / 6.0 - theta * theta / 120.0, (safe - jnp.sin(safe)) / (safe**3)
    )  # (t - sin t)/t^3
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + b[..., None, None] * K + c[..., None, None] * K2


def _left_jacobian_inv(phi: jnp.ndarray) -> jnp.ndarray:
    theta = _safe_norm(phi)
    K = hat(phi)
    K2 = K @ K
    small = theta < 1e-4
    safe = jnp.where(small, 1.0, theta)
    half = safe * 0.5
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta * theta / 720.0,
        (1.0 - half * jnp.cos(half) / jnp.sin(half)) / (safe * safe),
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye - 0.5 * K + cot_term[..., None, None] * K2


def exp(xi: jnp.ndarray) -> jnp.ndarray:
    """se(3) exponential: (..., 6) [rho, phi] -> (..., 4, 4) transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = (_left_jacobian(phi) @ rho[..., None])[..., 0]
    return from_Rt(R, t)


def log(T: jnp.ndarray) -> jnp.ndarray:
    """se(3) logarithm: (..., 4, 4) -> (..., 6) [rho, phi]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    phi = so3_log(R)
    rho = (_left_jacobian_inv(phi) @ t[..., None])[..., 0]
    return jnp.concatenate([rho, phi], axis=-1)


def from_Rt(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Assemble (..., 4, 4) from (..., 3, 3) rotation and (..., 3) translation."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (4,)
    )[..., None, :]
    return jnp.concatenate([top, bottom], axis=-2)


def inverse(T: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse of (..., 4, 4) rigid transforms."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return from_Rt(Rt, -(Rt @ t[..., None])[..., 0])


def transform(T: jnp.ndarray, points: jnp.ndarray) -> jnp.ndarray:
    """Apply (..., 4, 4) to (..., N, 3) or (..., 3) points."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    if points.ndim == T.ndim:  # (..., N, 3): batch dims match, extra N axis
        return points @ jnp.swapaxes(R, -1, -2) + t[..., None, :]
    return (R @ points[..., None])[..., 0] + t


def camera_center(Tcw: jnp.ndarray) -> jnp.ndarray:
    """Camera center in world coords (reference ``Ow``): -R^T t."""
    R, t = Tcw[..., :3, :3], Tcw[..., :3, 3]
    return -(jnp.swapaxes(R, -1, -2) @ t[..., None])[..., 0]


def to_quaternion(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) [x, y, z, w].

    TUM-trajectory export ordering (reference SaveKeyFrameTrajectoryTUM,
    System.h:345-349). Branchless Shepperd-style selection via where.
    """
    m = R
    t0 = 1.0 + m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    t1 = 1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2]
    t2 = 1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2]
    t3 = 1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]

    def branch0():
        s = jnp.sqrt(jnp.clip(t0, _EPS, None)) * 2.0
        return jnp.stack(
            [
                (m[..., 2, 1] - m[..., 1, 2]) / s,
                (m[..., 0, 2] - m[..., 2, 0]) / s,
                (m[..., 1, 0] - m[..., 0, 1]) / s,
                0.25 * s,
            ],
            axis=-1,
        )

    def branch1():
        s = jnp.sqrt(jnp.clip(t1, _EPS, None)) * 2.0
        return jnp.stack(
            [
                0.25 * s,
                (m[..., 0, 1] + m[..., 1, 0]) / s,
                (m[..., 0, 2] + m[..., 2, 0]) / s,
                (m[..., 2, 1] - m[..., 1, 2]) / s,
            ],
            axis=-1,
        )

    def branch2():
        s = jnp.sqrt(jnp.clip(t2, _EPS, None)) * 2.0
        return jnp.stack(
            [
                (m[..., 0, 1] + m[..., 1, 0]) / s,
                0.25 * s,
                (m[..., 1, 2] + m[..., 2, 1]) / s,
                (m[..., 0, 2] - m[..., 2, 0]) / s,
            ],
            axis=-1,
        )

    def branch3():
        s = jnp.sqrt(jnp.clip(t3, _EPS, None)) * 2.0
        return jnp.stack(
            [
                (m[..., 0, 2] + m[..., 2, 0]) / s,
                (m[..., 1, 2] + m[..., 2, 1]) / s,
                0.25 * s,
                (m[..., 1, 0] - m[..., 0, 1]) / s,
            ],
            axis=-1,
        )

    qs = jnp.stack([branch0(), branch1(), branch2(), branch3()], axis=-2)
    which = jnp.argmax(jnp.stack([t0, t1, t2, t3], axis=-1), axis=-1)
    q = jnp.take_along_axis(qs, which[..., None, None], axis=-2)[..., 0, :]
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def from_quaternion(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion (..., 4) [x, y, z, w] -> rotation matrix (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
            jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
        ],
        axis=-2,
    )


def normalize_rotation(R: jnp.ndarray) -> jnp.ndarray:
    """Project (..., 3, 3) near-rotations back onto SO(3) via SVD."""
    U, _, Vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(U @ Vt)
    S = jnp.concatenate(
        [jnp.ones_like(det)[..., None], jnp.ones_like(det)[..., None], det[..., None]], axis=-1
    )
    return (U * S[..., None, :]) @ Vt


# vmapped conveniences used by the optimizers.
exp_batch = jax.vmap(exp)
log_batch = jax.vmap(log)
