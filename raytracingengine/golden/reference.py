"""Golden oracle: float64 CPU re-derivation of the reference semantics.

The reference repo does not build as checked in (no
TINYOBJLOADER_IMPLEMENTATION TU, box.obj missing — see SURVEY.md §5.6), so
this module is the trusted stand-in oracle: a direct, *naive-order* float64
NumPy implementation of the C++ engine's math, with real Python recursion
for TraceRay and per-ray loops — correctness over speed. Every JAX path is
validated against it (BASELINE.md).

Semantics mirrored (with citations):
  * camera ray: Math.h:99-121 (focal in pixels, Y flip, jitter in [0,1)px)
  * sphere/plane/triangle intersection epsilons: Shape.h:72-98, :149-159,
    :202-220
  * closest-hit family order + strict-< tie-break: Scene.h:218-257
  * transmittance march: Scene.h:35-77
  * direct lighting + Blinn-Phong: Scene.h:79-129
  * TraceRay weighting, Schlick Fresnel, TIR: Scene.h:131-198
  * AA loop with deterministic sample 0: Scene.h:283-309
  * tonemap family incl. float32-rounded constants:
    RaytracingEngine.cpp:70-214

Intersections are vectorized over primitives within a family (exact same
formulas, evaluated per-primitive), which changes nothing numerically —
each pair's arithmetic is identical to the scalar loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np

EPS = 1e-6


def _norm(v: np.ndarray) -> np.ndarray:
    l = np.sqrt(np.dot(v, v))
    if l <= 1e-12:
        return np.zeros(3)
    return v / l


def _reflect(v: np.ndarray, n: np.ndarray) -> np.ndarray:
    return v - n * (2.0 * np.dot(v, n))


def _refract(v: np.ndarray, n: np.ndarray, eta: float) -> np.ndarray:
    i = _norm(v)
    nn = _norm(n)
    cosi = np.clip(np.dot(i, nn), -1.0, 1.0)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    if k < 0.0:
        return np.zeros(3)
    return i * eta - nn * (eta * cosi + np.sqrt(k))


@dataclasses.dataclass
class GoldenHit:
    t: float
    point: np.ndarray
    normal: np.ndarray
    albedo: np.ndarray
    shininess: float
    specular: float
    transparency: float
    refractive_index: float


class GoldenScene:
    """fp64 oracle scene. Arrays are float64 SoA like the JAX scene."""

    def __init__(self):
        self.sph_centers = np.zeros((0, 3))
        self.sph_radii = np.zeros((0,))
        self.sph_mats: list[dict] = []
        self.pl_points = np.zeros((0, 3))
        self.pl_normals = np.zeros((0, 3))
        self.pl_mats: list[dict] = []
        self.tri_v0 = np.zeros((0, 3))
        self.tri_v1 = np.zeros((0, 3))
        self.tri_v2 = np.zeros((0, 3))
        self.tri_mats: list[dict] = []
        self.light_pos = np.zeros((0, 3))
        self.light_color = np.zeros((0, 3))
        self.light_intensity = np.zeros((0,))
        # camera
        self.cam_pos = np.zeros(3)
        self.focal = 1.0
        self.width = 0
        self.height = 0
        self.near = 1.0
        self.far = 1000.0
        self.spp = 32
        self.max_depth = 10
        self.bias = 1e-3
        self.rng = np.random.default_rng(0)

    # ---- intersection (vectorized over primitives, reference formulas) ----

    def _isect_spheres(self, o, d):
        """Shape.h:72-98; returns t per sphere, +inf miss."""
        if len(self.sph_radii) == 0:
            return np.zeros((0,))
        oc = o[None, :] - self.sph_centers
        a = np.dot(d, d)
        b = 2.0 * (oc @ d)
        c = np.sum(oc * oc, axis=1) - self.sph_radii**2
        disc = b * b - 4.0 * a * c
        with np.errstate(invalid="ignore"):
            sq = np.sqrt(np.maximum(disc, 0.0))
        t0 = (-b - sq) / (2.0 * a)
        t1 = (-b + sq) / (2.0 * a)
        lo = np.minimum(t0, t1)
        hi = np.maximum(t0, t1)
        t = np.where(lo >= EPS, lo, hi)
        t = np.where((disc >= 0.0) & (t >= EPS), t, np.inf)
        return t

    def _isect_planes(self, o, d):
        """Shape.h:149-159; |denom| > 1e-6, t >= 0."""
        if len(self.pl_points) == 0:
            return np.zeros((0,))
        denom = self.pl_normals @ d
        ok = np.abs(denom) > EPS
        p0l0 = self.pl_points - o[None, :]
        num = np.sum(p0l0 * self.pl_normals, axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = num / denom
        t = np.where(ok & (t >= 0.0), t, np.inf)
        return t

    def _isect_triangles(self, o, d):
        """Möller–Trumbore, Shape.h:202-220 (naive order, fp64)."""
        if len(self.tri_mats) == 0:
            return np.zeros((0,))
        e1 = self.tri_v1 - self.tri_v0
        e2 = self.tri_v2 - self.tri_v0
        h = np.cross(d[None, :], e2)
        a = np.sum(e1 * h, axis=1)
        ok = np.abs(a) > EPS
        with np.errstate(divide="ignore", invalid="ignore"):
            f = 1.0 / a
            s = o[None, :] - self.tri_v0
            u = f * np.sum(s * h, axis=1)
            q = np.cross(s, e1)
            v = f * (q @ d)
            t = f * np.sum(e2 * q, axis=1)
            ok &= (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS)
        return np.where(ok, t, np.inf)

    def intersect_closest(self, o, d) -> GoldenHit | None:
        """Scene.h:218-257: family order, strict-< keeps the first."""
        t_s = self._isect_spheres(o, d)
        t_p = self._isect_planes(o, d)
        t_t = self._isect_triangles(o, d)
        t_all = np.concatenate([t_s, t_p, t_t])
        if t_all.size == 0 or not np.isfinite(t_all.min()):
            return None
        j = int(np.argmin(t_all))  # first minimum == reference tie-break
        t = float(t_all[j])
        point = o + d * t
        ns, npl = len(t_s), len(t_p)
        if j < ns:
            normal = _norm(point - self.sph_centers[j])
            mat = self.sph_mats[j]
        elif j < ns + npl:
            normal = self.pl_normals[j - ns].copy()
            mat = self.pl_mats[j - ns]
        else:
            k = j - ns - npl
            e1 = self.tri_v1[k] - self.tri_v0[k]
            e2 = self.tri_v2[k] - self.tri_v0[k]
            normal = _norm(np.cross(e1, e2))
            mat = self.tri_mats[k]
        return GoldenHit(
            t=t,
            point=point,
            normal=normal,
            albedo=np.asarray(mat["color"], np.float64),
            shininess=float(mat["shininess"]),
            specular=float(mat["specular"]),
            transparency=float(mat["transparency"]),
            refractive_index=float(mat["refractive_index"]),
        )

    # ---- shading ----------------------------------------------------------

    def background(self, d):
        """Scene.h:30-33."""
        t = 0.5 * (_norm(d)[1] + 1.0)
        return np.array([1.0, 1.0, 1.0]) * (1.0 - t) + np.array([0.5, 0.7, 1.0]) * t

    def transmittance(self, o, d, max_dist, bias):
        """Scene.h:35-77."""
        T = 1.0
        traveled = 0.0
        origin = o.copy()
        safety = 64
        while safety > 0 and T > 1e-4 and traveled < max_dist:
            safety -= 1
            hit = self.intersect_closest(origin, d)
            if hit is None:
                break
            t = hit.t
            if t <= 0.0:
                origin = origin + d * bias
                traveled += bias
                continue
            if t <= bias:
                origin = origin + d * (t + bias)
                traveled += t + bias
                continue
            if traveled + t >= max_dist:
                break
            T *= float(np.clip(hit.transparency, 0.0, 1.0))
            origin = origin + d * (t + bias)
            traveled += t + bias
        return float(np.clip(T, 0.0, 1.0))

    def direct_light(self, hit: GoldenHit, view_dir, normal, bias):
        """Scene.h:79-129."""
        normal = _norm(normal)
        diffuse_acc = np.zeros(3)
        spec_acc = np.zeros(3)
        for li in range(len(self.light_intensity)):
            vec = self.light_pos[li] - hit.point
            dist = float(np.sqrt(np.dot(vec, vec)))
            if dist <= 0.0:
                continue
            ldir = vec / dist
            ndotl = max(0.0, float(np.dot(normal, ldir)))
            if ndotl <= 0.0:
                continue
            if dist <= bias:
                continue
            shadow_o = hit.point + normal * bias
            T = self.transmittance(shadow_o, ldir, dist - bias, bias)
            if T <= bias:
                continue
            emitted = self.light_color[li] * self.light_intensity[li]
            contribution = emitted * (1.0 / (dist * dist)) * ndotl
            diffuse_acc += contribution * T
            if hit.transparency <= 0.0 and hit.specular > 0.0:
                half = _norm(ldir + view_dir)
                ndoth = max(0.0, float(np.dot(normal, half)))
                if ndoth > 0.0:
                    spec_acc += emitted * (1.0 / (dist * dist)) * (
                        ndoth**hit.shininess
                    ) * T
        return hit.albedo * diffuse_acc + spec_acc * hit.specular

    def trace_ray(self, o, d, depth, bias):
        """Scene.h:131-198 — real recursion."""
        if depth >= self.max_depth:
            return self.background(d)
        hit = self.intersect_closest(o, d)
        if hit is None:
            return self.background(d)

        incoming = _norm(d)
        front = np.dot(hit.normal, incoming) < 0.0
        normal = hit.normal if front else -hit.normal
        view = -incoming
        cos_theta = max(0.0, float(np.dot(normal, view)))

        eta_t = hit.refractive_index
        f0 = ((eta_t - 1.0) / (eta_t + 1.0)) ** 2
        fresnel = f0 + (1.0 - f0) * (1.0 - cos_theta) ** 5
        tau = float(np.clip(hit.transparency, 0.0, 1.0))

        local = self.direct_light(hit, view, normal, bias)
        final = np.zeros(3)
        if tau < 1.0:
            final += local * (1.0 - tau)

        if tau > 0.0:
            eta = (1.0 / eta_t) if front else eta_t
            refr = _refract(incoming, normal, eta)
            if np.sqrt(np.dot(refr, refr)) > bias:
                refr = _norm(refr)
                child = self.trace_ray(
                    hit.point + refr * (bias * 1e2), refr, depth + 1, bias
                )
                final += child * (tau * (1.0 - fresnel))
            else:
                fresnel = 1.0  # TIR (Scene.h:185)

        reflectiveness = fresnel if tau > 0.0 else hit.specular
        if reflectiveness > bias:
            refl = _norm(_reflect(incoming, normal))
            child = self.trace_ray(hit.point + refl * bias, refl, depth + 1, bias)
            final += child * reflectiveness

        return final

    # ---- camera + frame ---------------------------------------------------

    def get_ray(self, px, py, jitter=None):
        """Math.h:99-121."""
        sx = float(px) - self.width / 2.0
        sy = self.height / 2.0 - float(py)
        if jitter is not None:
            sx += jitter[0]
            sy += jitter[1]
        screen = np.array([sx, sy, self.cam_pos[2] + self.focal])
        d = _norm(screen - self.cam_pos)
        return self.cam_pos.copy(), d

    def render_pixel(self, px, py):
        """Scene.h:283-309: sample 0 center, rest jittered uniform [0,1)."""
        acc = np.zeros(3)
        for s in range(self.spp):
            jitter = None if s == 0 else self.rng.random(2)
            o, d = self.get_ray(px, py, jitter)
            acc += self.trace_ray(o, d, 0, self.bias)
        return acc / self.spp

    def render(self) -> np.ndarray:
        """-> HDR [H, W, 3] float64, row-major like Scene.h:311-328."""
        img = np.zeros((self.height, self.width, 3))
        for y in range(self.height):
            for x in range(self.width):
                img[y, x] = self.render_pixel(x, y)
        return img

    def render_rays(self, origins, dirs) -> np.ndarray:
        """Trace arbitrary ray arrays [R,3] -> [R,3] (testing hook)."""
        out = np.zeros_like(origins)
        for i in range(origins.shape[0]):
            out[i] = self.trace_ray(origins[i], dirs[i], 0, self.bias)
        return out


# ---- tonemaps (float64 with float32-rounded curve constants) -------------

_F32 = lambda x: float(np.float32(x))
_LUMA = np.array([0.2126, 0.7152, 0.0722])


def g_luminance(c):
    return c @ _LUMA


def g_change_luminance(c, l_out):
    return c * (l_out / g_luminance(c))[..., None]


def g_simple(c):
    return np.clip(c, 0.0, 1.0)


def g_reinhard_simple(c):
    return c / (c + 1.0)


def g_reinhard_extended(c, max_white=5.0):
    return (c * (c / (max_white * max_white) + 1.0)) / (c + 1.0)


def g_reinhard_extended_luminance(c, max_white=5.0):
    l_old = g_luminance(c)
    l_new = (l_old * (1.0 + l_old / (max_white * max_white))) / (1.0 + l_old)
    return g_change_luminance(c, l_new)


def g_reinhard_jodie(c, a=0.18):
    l = g_luminance(c)
    l_mapped = (a / np.log(2.0 + (l / 0.85) ** 1.7)) * np.log(1.0 + l)
    return g_change_luminance(c, l_mapped)


def _g_uncharted2_partial(x):
    a, b, c, d, e, f = map(_F32, (0.15, 0.50, 0.10, 0.20, 0.02, 0.30))
    return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


def g_uncharted2(c):
    curr = _g_uncharted2_partial(c * 2.0)
    white_scale = 1.0 / _g_uncharted2_partial(np.full(3, 11.2))
    return curr * white_scale


def g_aces(c):
    v = c * _F32(0.6)
    a, b, cc, d, e = map(_F32, (2.51, 0.03, 2.43, 0.59, 0.14))
    return np.clip((v * (a * v + b)) / (v * (cc * v + d) + e), 0.0, 1.0)


GOLDEN_OPERATORS = {
    "simple": g_simple,
    "reinhard_simple": g_reinhard_simple,
    "reinhard_extended": g_reinhard_extended,
    "reinhard_extended_luminance": g_reinhard_extended_luminance,
    "reinhard_jodie": g_reinhard_jodie,
    "uncharted2": g_uncharted2,
    "aces": g_aces,
}


def g_to_uint8(mapped):
    """toColor (RaytracingEngine.cpp:113-121): clamp01, *255, truncate."""
    return (np.clip(mapped, 0.0, 1.0) * 255.0).astype(np.uint8)


def golden_from_scene(scene, camera, max_depth=10, bias=1e-3, seed=0) -> GoldenScene:
    """Build a GoldenScene from the JAX-side Scene + Camera pytrees
    (drops padding via the active masks)."""
    import numpy as _np

    g = GoldenScene()

    def mats_of(m, mask):
        return [
            {
                "color": _np.asarray(m.color[i], _np.float64),
                "shininess": float(m.shininess[i]),
                "specular": float(m.specular[i]),
                "transparency": float(m.transparency[i]),
                "refractive_index": float(m.refractive_index[i]),
            }
            for i in range(mask.shape[0])
            if bool(mask[i])
        ]

    sm = _np.asarray(scene.spheres.active)
    g.sph_centers = _np.asarray(scene.spheres.centers, _np.float64)[sm]
    g.sph_radii = _np.asarray(scene.spheres.radii, _np.float64)[sm]
    g.sph_mats = mats_of(scene.spheres.materials, sm)
    pm = _np.asarray(scene.planes.active)
    g.pl_points = _np.asarray(scene.planes.points, _np.float64)[pm]
    g.pl_normals = _np.asarray(scene.planes.normals, _np.float64)[pm]
    g.pl_mats = mats_of(scene.planes.materials, pm)
    tm = _np.asarray(scene.triangles.active)
    g.tri_v0 = _np.asarray(scene.triangles.v0, _np.float64)[tm]
    g.tri_v1 = _np.asarray(scene.triangles.v1, _np.float64)[tm]
    g.tri_v2 = _np.asarray(scene.triangles.v2, _np.float64)[tm]
    g.tri_mats = mats_of(scene.triangles.materials, tm)
    lm = _np.asarray(scene.lights.active)
    g.light_pos = _np.asarray(scene.lights.positions, _np.float64)[lm]
    g.light_color = _np.asarray(scene.lights.colors, _np.float64)[lm]
    g.light_intensity = _np.asarray(scene.lights.intensities, _np.float64)[lm]

    g.cam_pos = _np.asarray(camera.position, _np.float64)
    g.focal = float(camera.focal)
    g.width = camera.width
    g.height = camera.height
    g.near = float(camera.near)
    g.far = float(camera.far)
    g.spp = camera.spp
    g.max_depth = max_depth
    g.bias = bias
    g.rng = _np.random.default_rng(seed)
    return g
