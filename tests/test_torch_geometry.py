"""The port's geometry modules (se3, linsolve, camera, robust, triangulation)
against their JAX twins, on inputs made with numpy from a seed.

Tolerances: fp32 elementwise math in the same order on both sides, so
agreement to a few ulp of the values' scale (stated per test).
"""

import numpy as np
import pytest
import torch

from android_svo_tpu.geometry import camera as jcam
from android_svo_tpu.geometry import linsolve as jls
from android_svo_tpu.geometry import robust as jrob
from android_svo_tpu.geometry import se3 as jse3
from android_svo_tpu.geometry import triangulation as jtri

from android_svo_tpu_torch.geometry import camera as cam
from android_svo_tpu_torch.geometry import linsolve as ls
from android_svo_tpu_torch.geometry import robust as rob
from android_svo_tpu_torch.geometry import se3
from android_svo_tpu_torch.geometry import triangulation as tri

RNG = np.random.default_rng(0)
ATOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def close(a, b, atol=ATOL, rtol=1e-5):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=rtol)


def rand(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def unit_quats(n):
    q = rand(n, 4)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# twists including the small-angle Taylor branch
TWISTS = {
    "large": rand(16, 6, scale=0.6),
    "small": rand(16, 6, scale=1e-5),
}


class TestSE3:
    @pytest.mark.parametrize("fn", ["quat_mul", "quat_rotate"])
    def test_quat_ops(self, fn):
        p, q = unit_quats(16), unit_quats(16)
        v = rand(16, 3)
        if fn == "quat_mul":
            close(se3.quat_mul(t(p), t(q)), jse3.quat_mul(p, q))
        else:
            close(se3.quat_rotate(t(q), t(v)), jse3.quat_rotate(q, v))

    def test_quat_matrix_roundtrip(self):
        q = unit_quats(32)
        m = np.asarray(jse3.quat_to_matrix(q))
        close(se3.quat_to_matrix(t(q)), m)
        close(se3.matrix_to_quat(t(m)), jse3.matrix_to_quat(m), atol=2e-5)

    def test_hat(self):
        v = rand(8, 3)
        close(se3.hat(t(v)), jse3.hat(v))

    @pytest.mark.parametrize("kind", sorted(TWISTS))
    def test_exp_log(self, kind):
        xi = TWISTS[kind]
        Tj = jse3.SE3.exp(xi)
        Tp = se3.SE3.exp(t(xi))
        close(Tp.q, Tj.q)
        close(Tp.t, Tj.t)
        close(Tp.log(), Tj.log(), atol=2e-5)
        close(se3.SO3.exp(t(xi[:, 3:])), jse3.SO3.exp(xi[:, 3:]))
        close(se3.SO3.log(Tp.q), jse3.SO3.log(Tj.q), atol=2e-5)

    def test_compose_inverse_apply(self):
        a, b = TWISTS["large"][:8], TWISTS["large"][8:]
        Aj, Bj = jse3.SE3.exp(a), jse3.SE3.exp(b)
        Ap, Bp = se3.SE3.exp(t(a)), se3.SE3.exp(t(b))
        pts = rand(8, 3)
        Cj, Cp = Aj.compose(Bj), Ap.compose(Bp)
        close(Cp.q, Cj.q)
        close(Cp.t, Cj.t)
        close(Ap.inverse().t, Aj.inverse().t)
        close(Ap.apply(t(pts)), Aj.apply(pts))
        # a single pose broadcasts over a batch of points
        A0 = se3.SE3(q=Ap.q[0], t=Ap.t[0])
        close(A0.apply(t(pts)), Aj[0].apply(pts))
        close(Ap.rotation_matrix(), Aj.rotation_matrix())

    def test_from_rt(self):
        R = np.asarray(jse3.quat_to_matrix(unit_quats(8)))
        tt = rand(8, 3)
        Tj = jse3.SE3.from_rt(R, tt)
        Tp = se3.SE3.from_rt(t(R), t(tt))
        close(Tp.q, Tj.q, atol=2e-5)
        close(Tp.t, Tj.t)


def spd(n, d, cond=1.0):
    A = rand(n, d, d)
    return (A @ A.transpose(0, 2, 1) + cond * np.eye(d)).astype(np.float32)


class TestLinsolve:
    @pytest.mark.parametrize("d", [2, 3, 6])
    def test_solve_and_inverse(self, d):
        H = spd(12, d)
        g = rand(12, d)
        close(ls.solve_spd(t(H), t(g)), jls.solve_spd(H, g), atol=1e-4)
        close(ls.inv_spd(t(H)), jls.inv_spd(H), atol=1e-4)

    def test_singular_is_finite_and_same(self):
        H = np.zeros((2, 3, 3), np.float32)
        g = np.ones((2, 3), np.float32)
        a = ls.solve_spd(t(H), t(g))
        b = jls.solve_spd(H, g)
        assert torch.isfinite(a).all()
        close(a, b, rtol=1e-6)

    def test_2x2(self):
        A = rand(10, 2, 2)
        close(ls.det2x2(t(A)), jls.det2x2(A))
        close(ls.inv2x2(t(A)), jls.inv2x2(A), atol=1e-3, rtol=1e-4)


CAMS = {
    "free": dict(),
    "radtan": dict(k1=-0.28, k2=0.07, p1=2e-4, p2=-1e-4, k3=0.0),
}


class TestCamera:
    @pytest.mark.parametrize("kind", sorted(CAMS))
    def test_projection(self, kind):
        kw = CAMS[kind]
        cj = jcam.PinholeCamera.create(640, 480, 458.0, 457.0, 367.0, 248.0,
                                       **kw)
        cp = cam.PinholeCamera.create(640, 480, 458.0, 457.0, 367.0, 248.0,
                                      device="cpu", **kw)
        assert cp.distortion_free == cj.distortion_free
        xyz = rand(32, 3)
        xyz[:, 2] = np.abs(xyz[:, 2]) + 1.0
        close(cp.world2cam(t(xyz)), cj.world2cam(xyz), atol=1e-3)
        px = (RNG.random((32, 2)) * [640, 480]).astype(np.float32)
        close(cp.cam2world(t(px)), cj.cam2world(px), atol=2e-5)

    def test_project_unproject(self):
        xyz = rand(8, 3)
        close(cam.project2d(t(xyz)), jcam.project2d(xyz), rtol=1e-5,
              atol=1e-4)
        close(cam.unproject2d(t(xyz[:, :2])), jcam.unproject2d(xyz[:, :2]))


class TestRobust:
    @pytest.mark.parametrize("n_valid", [0, 1, 7, 20])
    def test_masked_median_and_mad(self, n_valid):
        x = rand(20)
        m = np.zeros(20, bool)
        m[:n_valid] = True
        RNG.shuffle(m)
        close(tri.masked_median(t(x), t(m)), jtri.masked_median(x, m))
        close(rob.mad_scale(t(x), t(m)), jrob.mad_scale(x, m))

    def test_weights(self):
        x = rand(64, scale=10.0)
        close(rob.tukey_weight(t(x)), jrob.tukey_weight(x))


class TestTriangulation:
    def _pair(self, n=24):
        T = jse3.SE3.exp(np.array([0.2, -0.05, 0.02, 0.01, 0.03, -0.02],
                                  np.float32))
        p = rand(n, 3)
        p[:, 2] = np.abs(p[:, 2]) + 2.0
        f_ref = p / np.linalg.norm(p, axis=-1, keepdims=True)
        pc = np.asarray(T.apply(p))
        f_cur = pc / np.linalg.norm(pc, axis=-1, keepdims=True)
        f_cur = f_cur + rand(n, 3, scale=1e-3)
        f_cur /= np.linalg.norm(f_cur, axis=-1, keepdims=True)
        Tp = se3.SE3(q=t(T.q), t=t(T.t))
        return T, Tp, f_ref.astype(np.float32), f_cur.astype(np.float32)

    def test_midpoint_and_depth(self):
        T, Tp, fr, fc = self._pair()
        I_j = jse3.SE3.identity()
        I_p = se3.SE3.identity()
        close(tri.triangulate_midpoint(I_p, Tp.inverse(), t(fr), t(fc)),
              jtri.triangulate_midpoint(I_j, T.inverse(), fr, fc), atol=1e-3,
              rtol=1e-4)
        dp, vp = tri.depth_from_triangulation(Tp, t(fr), t(fc))
        dj, vj = jtri.depth_from_triangulation(T, fr, fc)
        close(dp, dj, atol=1e-3, rtol=1e-4)
        close(vp, vj)

    def test_inliers_and_sampson(self):
        T, Tp, fr, fc = self._pair()
        xp, ip, ep = tri.compute_inliers(Tp, t(fr), t(fc), 2.0, 420.0)
        xj, ij, ej = jtri.compute_inliers(T, fr, fc, 2.0, 420.0)
        close(ip, ij)
        close(ep, ej, atol=1e-2, rtol=1e-4)
        E_j = np.asarray(jtri.essential_from_pose(T))
        E_p = t(E_j)
        close(tri.sampson_error(E_p, t(fr), t(fc)),
              jtri.sampson_error(E_j, fr, fc), atol=1e-9, rtol=1e-3)
