// Fast Wavefront OBJ parser with a C ABI for ctypes.
//
// Native counterpart of the reference's vendored tiny_obj_loader
// (tiny_obj_loader.h, used via LoadObject at RaytracingEngine.cpp:15-65):
// parses `v` positions and `f` faces (v, v/vt, v//vn, v/vt/vn, negative
// indices, polygon fan triangulation — the reference passes
// triangulate=true), tracks usemtl indices. Written from scratch; no
// tinyobj code. Output layout mirrors the Python loader
// (raytracingengine/imageio/obj.py) exactly: flat float64 vertices,
// flat int64 triangle indices, int32 per-face material ids.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct ObjData {
  std::vector<double> vertices;       // 3 per vertex
  std::vector<int64_t> indices;       // 3 per triangle
  std::vector<int32_t> face_mats;     // per triangle
  std::vector<std::string> mat_names; // usemtl names in first-seen order
  std::string error;
};

// Fast float parse: strtod on a pre-located token.
inline const char* skip_ws(const char* p) {
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
  return p;
}

inline const char* next_token(const char* p, const char** tok_end) {
  p = skip_ws(p);
  const char* e = p;
  while (*e && *e != ' ' && *e != '\t' && *e != '\r' && *e != '\n') ++e;
  *tok_end = e;
  return p;
}

}  // namespace

extern "C" {

// Parse `path`. Returns an opaque handle (heap ObjData*) or nullptr.
void* rte_obj_parse(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize(static_cast<size_t>(size));
  if (size > 0 && std::fread(buf.data(), 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  auto* data = new ObjData();
  std::unordered_map<std::string, int32_t> mat_lookup;
  int32_t cur_mat = -1;

  const char* p = buf.c_str();
  const char* end = p + buf.size();
  std::vector<int64_t> face;  // scratch per face
  while (p < end) {
    const char* line_end = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    const char* q = skip_ws(p);
    if (q[0] == 'v' && (q[1] == ' ' || q[1] == '\t')) {
      char* ep;
      double x = std::strtod(q + 1, &ep);
      double y = std::strtod(ep, &ep);
      double z = std::strtod(ep, &ep);
      data->vertices.push_back(x);
      data->vertices.push_back(y);
      data->vertices.push_back(z);
    } else if (q[0] == 'f' && (q[1] == ' ' || q[1] == '\t')) {
      face.clear();
      const char* t = q + 1;
      while (t < line_end) {
        const char* te;
        t = next_token(t, &te);
        if (t >= line_end || t == te) break;
        // vertex index is the leading integer of the token (before '/')
        char* ep;
        long long vi = std::strtoll(t, &ep, 10);
        int64_t idx =
            vi > 0 ? vi - 1
                   : static_cast<int64_t>(data->vertices.size() / 3) + vi;
        face.push_back(idx);
        t = te;
      }
      for (size_t k = 1; k + 1 < face.size(); ++k) {
        data->indices.push_back(face[0]);
        data->indices.push_back(face[k]);
        data->indices.push_back(face[k + 1]);
        data->face_mats.push_back(cur_mat);
      }
    } else if (std::strncmp(q, "usemtl", 6) == 0) {
      const char* te;
      const char* t = next_token(q + 6, &te);
      std::string name(t, te);
      auto it = mat_lookup.find(name);
      if (it == mat_lookup.end()) {
        cur_mat = static_cast<int32_t>(data->mat_names.size());
        mat_lookup.emplace(name, cur_mat);
        data->mat_names.push_back(name);
      } else {
        cur_mat = it->second;
      }
    }
    p = line_end + 1;
  }

  // Validate indices.
  int64_t nv = static_cast<int64_t>(data->vertices.size() / 3);
  for (int64_t idx : data->indices) {
    if (idx < 0 || idx >= nv) {
      data->error = "OBJ face index out of range";
      break;
    }
  }
  return data;
}

int64_t rte_obj_num_vertices(void* h) {
  return static_cast<ObjData*>(h)->vertices.size() / 3;
}
int64_t rte_obj_num_triangles(void* h) {
  return static_cast<ObjData*>(h)->indices.size() / 3;
}
int32_t rte_obj_num_materials(void* h) {
  return static_cast<int32_t>(static_cast<ObjData*>(h)->mat_names.size());
}
const char* rte_obj_error(void* h) {
  ObjData* d = static_cast<ObjData*>(h);
  return d->error.empty() ? nullptr : d->error.c_str();
}
const char* rte_obj_material_name(void* h, int32_t i) {
  ObjData* d = static_cast<ObjData*>(h);
  if (i < 0 || i >= static_cast<int32_t>(d->mat_names.size())) return nullptr;
  return d->mat_names[static_cast<size_t>(i)].c_str();
}

// Copy out into caller-allocated buffers.
void rte_obj_copy(void* h, double* verts, int64_t* indices, int32_t* mats) {
  ObjData* d = static_cast<ObjData*>(h);
  if (verts) std::memcpy(verts, d->vertices.data(),
                         d->vertices.size() * sizeof(double));
  if (indices) std::memcpy(indices, d->indices.data(),
                           d->indices.size() * sizeof(int64_t));
  if (mats) std::memcpy(mats, d->face_mats.data(),
                        d->face_mats.size() * sizeof(int32_t));
}

void rte_obj_free(void* h) { delete static_cast<ObjData*>(h); }

}  // extern "C"
