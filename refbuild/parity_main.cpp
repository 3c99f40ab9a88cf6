// Parity driver: renders deterministic (spp=1, jitter off) frames with the
// UNMODIFIED reference engine headers (/root/reference/RaytracingEngine) and
// dumps raw fp64 HDR buffers, so the JAX renderer can be compared against the
// real C++ engine rather than a re-derived oracle.
//
// Scenes mirror raytracingengine.scenes.builders:
//   head_box          — main()'s HEAD scene (RaytracingEngine.cpp:216-290) with
//                       the missing box.obj replaced by the same procedural
//                       cube the JAX build uses (scenes/assets.cube_mesh(4.0)).
//   baseline_spheres  — builders.baseline_sphere_scene (BASELINE config #1).
//   glass             — builders.glass_sphere_scene (refraction/Fresnel/TIR).
//
// Determinism: Camera::antiAliasingAmount is a public member; setting it to 1
// makes GeneratePixelAt take only sample 0, which is never jittered
// (Scene.h:292 — `aa > 0 && aaCount > 1`), so the render is bit-reproducible.
//
// Output format (one file per scene): "RTEHDR1\n" magic, int32 width, int32
// height (little-endian), then width*height*3 float64 RGB, row-major with
// idx = y*width + x (the engine's own pixel order, Scene.h:321-324).

#include "Math.h"
#include "Shape.h"
#include "Light.h"
#include "Scene.h"

#include <chrono>
#include <cstdint>
#include <fstream>
#include <iostream>
#include <string>
#include <vector>

namespace {

void dumpHDR(const std::string& path, const std::vector<Vec3>& px, int w, int h) {
    std::ofstream f(path, std::ios::binary);
    if (!f) throw std::runtime_error("cannot open " + path);
    f.write("RTEHDR1\n", 8);
    int32_t wi = w, hi = h;
    f.write(reinterpret_cast<const char*>(&wi), 4);
    f.write(reinterpret_cast<const char*>(&hi), 4);
    for (const Vec3& p : px) {
        double rgb[3] = {p.x, p.y, p.z};
        f.write(reinterpret_cast<const char*>(rgb), sizeof rgb);
    }
    std::cout << "wrote " << path << " (" << w << "x" << h << ")\n";
}

// The procedural cube (size 4, centered at origin) that the JAX build's
// scenes/assets.cube_mesh(4.0) produces; vertex/index order matches box.obj.
Model proceduralCube(const Transform& t, const Material& m) {
    const double s = 2.0;
    std::vector<Vec3> verts = {
        Vec3(-s, -s, -s), Vec3(s, -s, -s), Vec3(s, s, -s), Vec3(-s, s, -s),
        Vec3(-s, -s, s),  Vec3(s, -s, s),  Vec3(s, s, s),  Vec3(-s, s, s),
    };
    std::vector<int> idx = {
        0, 2, 1,  0, 3, 2,  4, 5, 6,  4, 6, 7,  0, 1, 5,  0, 5, 4,
        3, 7, 6,  3, 6, 2,  0, 4, 7,  0, 7, 3,  1, 2, 6,  1, 6, 5,
    };
    return Model(idx, t, m, verts);
}

Scene headBoxScene(int width, int height) {
    Camera camera(Vec3(0, 0, -25), 500, width, height, 0, 200);
    camera.antiAliasingAmount = 1;
    Scene scene(camera);

    Material boxMat{.color = Vec3(0, 0, 1), .shininess = 128.0,
                    .specular = 0.5, .transparency = 0.0,
                    .refractiveIndex = 1.5};
    Transform boxT{Vec3(0, 0, 10), Vec3(0, 0, 0), Vec3(1, 1, 1)};
    Model box = proceduralCube(boxT, boxMat);
    scene.AddModel(box);

    const double distance = 15;
    const Vec3 normals[5] = {Vec3(0, 0, -1), Vec3(1, 0, 0), Vec3(-1, 0, 0),
                             Vec3(0, 1, 0), Vec3(0, -1, 0)};
    const Vec3 colors[5] = {Vec3(1, 1, 1), Vec3(0, 1, 0), Vec3(0, 0, 1),
                            Vec3(1, 1, 1), Vec3(1, 1, 1)};
    for (int i = 0; i < 5; i++) {
        Material mat{.color = colors[i], .shininess = 0.128, .specular = 0.01,
                     .transparency = 0.0, .refractiveIndex = 1.5};
        Plane plane(normals[i] * -distance, normals[i], mat);
        scene.AddPlane(plane);
    }
    Light l1(Vec3(0, 0, -5), Vec3(1, 1, 1), 150);
    Light l2(Vec3(-2, 2, -5), Vec3(1, 1, 1), 150);
    scene.AddLight(l1);
    scene.AddLight(l2);
    return scene;
}

Scene baselineSphereScene(int width, int height) {
    Camera camera(Vec3(0, 0, -10), width, width, height, 0, 100);
    camera.antiAliasingAmount = 1;
    Scene scene(camera);

    Material m1{.color = Vec3(0.8, 0.2, 0.2)};
    Material m2{.color = Vec3(0.2, 0.8, 0.2), .shininess = 64.0, .specular = 0.3};
    Material m3{.color = Vec3(0.2, 0.2, 0.8), .shininess = 16.0, .specular = 0.05};
    Sphere s1(2.0, Vec3(0.0, 0.0, 6.0), m1);
    Sphere s2(1.0, Vec3(-3.0, -1.0, 9.0), m2);
    Sphere s3(1.5, Vec3(3.0, 1.0, 8.0), m3);
    scene.AddSphere(s1);
    scene.AddSphere(s2);
    scene.AddSphere(s3);
    Material floorMat{.color = Vec3(0.9, 0.9, 0.9)};
    Plane floor(Vec3(0.0, -2.5, 0.0), Vec3(0.0, 1.0, 0.0), floorMat);
    scene.AddPlane(floor);
    Light l(Vec3(0.0, 6.0, -2.0), Vec3(1, 1, 1), 80.0);
    scene.AddLight(l);
    return scene;
}

Scene glassScene(int width, int height) {
    Camera camera(Vec3(0, 0, -8), width, width, height, 0, 100);
    camera.antiAliasingAmount = 1;
    Scene scene(camera);

    Material glass{.color = Vec3(1.0, 1.0, 1.0), .shininess = 128.0,
                   .specular = 0.0, .transparency = 0.9,
                   .refractiveIndex = 1.5};
    Material orange{.color = Vec3(0.9, 0.4, 0.1)};
    Sphere s1(1.5, Vec3(0.0, 0.0, 5.0), glass);
    Sphere s2(1.0, Vec3(1.5, -0.8, 9.0), orange);
    scene.AddSphere(s1);
    scene.AddSphere(s2);
    Material floorMat{.color = Vec3(0.8, 0.8, 0.8)};
    Plane floor(Vec3(0.0, -2.0, 0.0), Vec3(0.0, 1.0, 0.0), floorMat);
    scene.AddPlane(floor);
    Light l(Vec3(-3.0, 5.0, -1.0), Vec3(1, 1, 1), 60.0);
    scene.AddLight(l);
    return scene;
}

// Dense procedural mesh matching scenes/assets.bumpy_sphere_mesh: a
// UV-sphere with radial displacement r = R*(1 + amp*sin(4 theta)*cos(3 phi)),
// ni polar x nj azimuthal segments -> nj*(2*ni - 2) triangles (6,016 for
// the defaults). Exercises Model's arbitrary-size triangle loop
// (Shape.h:269-300) far past any small-scene fast path.
Model bumpySphere(const Transform& t, const Material& m, double radius,
                  int ni, int nj, double amp) {
    std::vector<Vec3> verts((ni + 1) * nj);
    const double pi = 3.14159265358979323846;
    for (int i = 0; i <= ni; i++) {
        double theta = pi * i / ni;
        double st = std::sin(theta), ct = std::cos(theta);
        for (int j = 0; j < nj; j++) {
            double phi = 2.0 * pi * j / nj;
            double r = radius * (1.0 + amp * std::sin(4.0 * theta) *
                                           std::cos(3.0 * phi));
            verts[i * nj + j] =
                Vec3(r * st * std::cos(phi), r * ct, r * st * std::sin(phi));
        }
    }
    std::vector<int> idx;
    idx.reserve(3 * nj * (2 * ni - 2));
    for (int i = 0; i < ni; i++) {
        for (int j = 0; j < nj; j++) {
            int j1 = (j + 1) % nj;
            int a = i * nj + j;
            int b = (i + 1) * nj + j;
            int c = (i + 1) * nj + j1;
            int d = i * nj + j1;
            if (i > 0) { idx.push_back(a); idx.push_back(c); idx.push_back(d); }
            if (i < ni - 1) { idx.push_back(a); idx.push_back(b); idx.push_back(c); }
        }
    }
    return Model(idx, t, m, verts);
}

Scene denseMeshScene(int width, int height, int ni = 48, int nj = 64) {
    Camera camera(Vec3(0, 0, -8), width, width, height, 0, 100);
    camera.antiAliasingAmount = 1;
    Scene scene(camera);

    Material meshMat{.color = Vec3(0.85, 0.35, 0.2), .shininess = 64.0,
                     .specular = 0.25, .transparency = 0.0,
                     .refractiveIndex = 1.0};
    Transform meshT{Vec3(0.137, 0.5, 8), Vec3(0, 0, 0), Vec3(1, 1, 1)};
    Model mesh = bumpySphere(meshT, meshMat, 2.0, ni, nj, 0.15);
    scene.AddModel(mesh);
    Material floorMat{.color = Vec3(0.9, 0.9, 0.9)};
    Plane floor(Vec3(0.0, -2.5, 0.0), Vec3(0.0, 1.0, 0.0), floorMat);
    scene.AddPlane(floor);
    Light l1(Vec3(-4.0, 6.0, -2.0), Vec3(1, 1, 1), 120.0);
    Light l2(Vec3(4.0, 5.0, 2.0), Vec3(1, 1, 1), 90.0);
    scene.AddLight(l1);
    scene.AddLight(l2);
    return scene;
}

void renderAndDump(const std::string& name, const Scene& scene, int w, int h) {
    auto t0 = std::chrono::high_resolution_clock::now();
    std::vector<Vec3> px = scene.RenderImage();
    auto t1 = std::chrono::high_resolution_clock::now();
    double ms = std::chrono::duration<double, std::milli>(t1 - t0).count();
    double rays_per_s = (double)w * h / (ms / 1000.0);
    std::cout << name << ": " << ms << " ms spp=1 (" << rays_per_s
              << " primary rays/s)\n";
    dumpHDR(name + ".hdr64", px, w, h);
}

}  // namespace

int main(int argc, char** argv) {
    // Default: the three parity scenes. "bench" arg: timed spp=1 1080p run
    // of the HEAD scene only (for BASELINE measurement at bench resolution).
    std::string mode = argc > 1 ? argv[1] : "parity";
    if (mode == "bench") {
        Scene s = headBoxScene(1920, 1080);
        renderAndDump("head_box_1080p", s, 1920, 1080);
        return 0;
    }
    renderAndDump("head_box_1000", headBoxScene(1000, 1000), 1000, 1000);
    renderAndDump("head_box_1080p", headBoxScene(1920, 1080), 1920, 1080);
    renderAndDump("baseline_spheres_256", baselineSphereScene(256, 256), 256, 256);
    renderAndDump("glass_256", glassScene(256, 256), 256, 256);
    renderAndDump("dense_mesh_128", denseMeshScene(128, 128), 128, 128);
    // Full-resolution dense-mesh parity: the same pixel count of
    // real-engine scrutiny as the box scenes.
    renderAndDump("dense_mesh_512", denseMeshScene(512, 512), 512, 512);
    // Large-mesh parity: 50,800 triangles (ni=128, nj=200); the
    // reference's Model loop is size-unbounded (Shape.h:269-300).
    renderAndDump("dense_mesh_streamed_256",
                  denseMeshScene(256, 256, 128, 200), 256, 256);
    return 0;
}
