// Native host-runtime components for portrayer_tpu.
//
// The reference (sunjay/portrayer) is a pure-Rust program: its OBJ parsing
// (tobj, src/primitive/mesh.rs:57-61), PNG codec (the `image` crate,
// src/render.rs:165-223) and spatial-sort/partition machinery
// (src/kdtree/leaf.rs) are native code.  These are this framework's
// native equivalents for the host side of the pipeline: scene ingest and
// image output.  The device compute path stays JAX/XLA; Python binds these
// via ctypes (portrayer_tpu/native.py) with pure-Python fallbacks.
//
// Build: make -C native   (g++ -O2 -shared -fPIC, links zlib)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <zlib.h>

namespace {

// ---------------------------------------------------------------------------
// OBJ loader — semantics of tobj as used by the reference (mesh.rs:57-61):
// first model only, one unified index per distinct v/vt/vn corner triple,
// fan triangulation of polygonal faces.
// ---------------------------------------------------------------------------

struct ObjData {
  std::vector<double> pos;    // [V*3] unified positions
  std::vector<double> uv;     // [V*2]
  std::vector<double> norm;   // [V*3]
  std::vector<int64_t> tris;  // [T*3]
  bool has_uv = false;
  bool has_norm = false;
};

// Parse one (possibly signed, possibly empty) OBJ index field.
// Returns -1 when empty; otherwise a 0-based index.
int64_t parse_index(const char* s, const char* e, int64_t count) {
  if (s == e) return -1;
  int64_t v = strtoll(s, nullptr, 10);
  return v > 0 ? v - 1 : count + v;
}

ObjData* obj_parse(const char* path) {
  FILE* f = fopen(path, "r");
  if (!f) return nullptr;

  std::vector<double> vs, vts, vns;  // raw streams
  auto data = new ObjData();
  std::unordered_map<std::string, int64_t> index_of;
  bool any_face = false;
  bool all_uv = true, all_norm = true;

  char line[4096];
  while (fgets(line, sizeof(line), f)) {
    char* p = line;
    while (*p == ' ' || *p == '\t') p++;
    if (p[0] == 'v' && p[1] == ' ') {
      double x, y, z;
      if (sscanf(p + 2, "%lf %lf %lf", &x, &y, &z) == 3) {
        vs.push_back(x); vs.push_back(y); vs.push_back(z);
      }
    } else if (p[0] == 'v' && p[1] == 't' && p[2] == ' ') {
      double u, v;
      if (sscanf(p + 3, "%lf %lf", &u, &v) >= 1) {
        vts.push_back(u); vts.push_back(v);
      }
    } else if (p[0] == 'v' && p[1] == 'n' && p[2] == ' ') {
      double x, y, z;
      if (sscanf(p + 3, "%lf %lf %lf", &x, &y, &z) == 3) {
        vns.push_back(x); vns.push_back(y); vns.push_back(z);
      }
    } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      any_face = true;
      std::vector<int64_t> corner_ids;
      char* tok = p + 1;
      while (*tok) {
        while (*tok == ' ' || *tok == '\t') tok++;
        char* start = tok;
        while (*tok && *tok != ' ' && *tok != '\t' && *tok != '\n' &&
               *tok != '\r')
          tok++;
        if (tok == start) break;
        std::string key(start, tok - start);
        auto it = index_of.find(key);
        int64_t id;
        if (it != index_of.end()) {
          id = it->second;
        } else {
          // Split on '/': v, vt, vn fields.
          const char* a = key.c_str();
          const char* end = a + key.size();
          const char* s1 = std::find(a, end, '/');
          const char* s2 = s1 == end ? end : std::find(s1 + 1, end, '/');
          int64_t vi = parse_index(a, s1, (int64_t)vs.size() / 3);
          int64_t ti = s1 == end
                           ? -1
                           : parse_index(s1 + 1, s2, (int64_t)vts.size() / 2);
          int64_t ni = s2 == end
                           ? -1
                           : parse_index(s2 + 1, end, (int64_t)vns.size() / 3);
          id = (int64_t)data->pos.size() / 3;
          index_of.emplace(std::move(key), id);
          if (vi < 0 || vi * 3 + 2 >= (int64_t)vs.size()) {
            fclose(f);
            delete data;
            return nullptr;  // malformed; caller falls back to Python
          }
          data->pos.push_back(vs[vi * 3]);
          data->pos.push_back(vs[vi * 3 + 1]);
          data->pos.push_back(vs[vi * 3 + 2]);
          if (ti >= 0 && ti * 2 + 1 < (int64_t)vts.size()) {
            data->uv.push_back(vts[ti * 2]);
            data->uv.push_back(vts[ti * 2 + 1]);
          } else {
            data->uv.push_back(0.0);
            data->uv.push_back(0.0);
            all_uv = false;
          }
          if (ni >= 0 && ni * 3 + 2 < (int64_t)vns.size()) {
            data->norm.push_back(vns[ni * 3]);
            data->norm.push_back(vns[ni * 3 + 1]);
            data->norm.push_back(vns[ni * 3 + 2]);
          } else {
            data->norm.push_back(0.0);
            data->norm.push_back(0.0);
            data->norm.push_back(0.0);
            all_norm = false;
          }
        }
        corner_ids.push_back(id);
      }
      // Fan triangulation.
      for (size_t k = 1; k + 1 < corner_ids.size(); k++) {
        data->tris.push_back(corner_ids[0]);
        data->tris.push_back(corner_ids[k]);
        data->tris.push_back(corner_ids[k + 1]);
      }
    } else if ((p[0] == 'o' || p[0] == 'g') &&
               (p[1] == ' ' || p[1] == '\n' || p[1] == '\r')) {
      if (any_face) break;  // first model only (mesh.rs:57-61)
    }
  }
  fclose(f);
  data->has_uv = all_uv && !data->pos.empty();
  data->has_norm = all_norm && !data->pos.empty();
  return data;
}

void put_u32be(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back((v >> 24) & 0xFF);
  out.push_back((v >> 16) & 0xFF);
  out.push_back((v >> 8) & 0xFF);
  out.push_back(v & 0xFF);
}

void put_chunk(std::vector<uint8_t>& out, const char type[4],
               const uint8_t* body, size_t len) {
  put_u32be(out, (uint32_t)len);
  size_t start = out.size();
  out.insert(out.end(), type, type + 4);
  out.insert(out.end(), body, body + len);
  uint32_t crc =
      crc32(0, out.data() + start, (uint32_t)(out.size() - start));
  put_u32be(out, crc);
}

}  // namespace

extern "C" {

// ---------- OBJ ----------

void* pn_obj_load(const char* path) { return obj_parse(path); }

void pn_obj_counts(void* h, int64_t* n_verts, int64_t* n_tris,
                   int32_t* has_uv, int32_t* has_norm) {
  auto d = (ObjData*)h;
  *n_verts = (int64_t)d->pos.size() / 3;
  *n_tris = (int64_t)d->tris.size() / 3;
  *has_uv = d->has_uv ? 1 : 0;
  *has_norm = d->has_norm ? 1 : 0;
}

void pn_obj_fill(void* h, double* pos, double* uv, double* norm,
                 int64_t* tris) {
  auto d = (ObjData*)h;
  memcpy(pos, d->pos.data(), d->pos.size() * sizeof(double));
  if (!d->uv.empty()) memcpy(uv, d->uv.data(), d->uv.size() * sizeof(double));
  if (!d->norm.empty())
    memcpy(norm, d->norm.data(), d->norm.size() * sizeof(double));
  memcpy(tris, d->tris.data(), d->tris.size() * sizeof(int64_t));
}

void pn_obj_free(void* h) { delete (ObjData*)h; }

// ---------- PNG encode (8-bit RGB, zlib) ----------
// The reference writes PNGs through the `image` crate (render.rs:193-207);
// this is the native codec for Image::save.

int64_t pn_png_encode(const uint8_t* rgb, int32_t w, int32_t h,
                      uint8_t** out) {
  // Filtered scanlines (filter byte 0 per row).
  std::vector<uint8_t> raw((size_t)h * (1 + (size_t)w * 3));
  for (int32_t y = 0; y < h; y++) {
    uint8_t* row = raw.data() + (size_t)y * (1 + (size_t)w * 3);
    row[0] = 0;
    memcpy(row + 1, rgb + (size_t)y * w * 3, (size_t)w * 3);
  }
  uLongf zcap = compressBound((uLong)raw.size());
  std::vector<uint8_t> z(zcap);
  if (compress2(z.data(), &zcap, raw.data(), (uLong)raw.size(), 6) != Z_OK)
    return -1;
  z.resize(zcap);

  auto png = new std::vector<uint8_t>();
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  png->insert(png->end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = (w >> 24) & 0xFF; ihdr[1] = (w >> 16) & 0xFF;
  ihdr[2] = (w >> 8) & 0xFF;  ihdr[3] = w & 0xFF;
  ihdr[4] = (h >> 24) & 0xFF; ihdr[5] = (h >> 16) & 0xFF;
  ihdr[6] = (h >> 8) & 0xFF;  ihdr[7] = h & 0xFF;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // truecolor RGB
  ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
  put_chunk(*png, "IHDR", ihdr, 13);
  put_chunk(*png, "IDAT", z.data(), z.size());
  put_chunk(*png, "IEND", nullptr, 0);

  *out = png->data();
  // Leak bookkeeping: caller must pn_buf_free the vector via the side map.
  // Simpler: copy to malloc'd buffer.
  uint8_t* buf = (uint8_t*)malloc(png->size());
  memcpy(buf, png->data(), png->size());
  int64_t len = (int64_t)png->size();
  delete png;
  *out = buf;
  return len;
}

void pn_free(void* p) { free(p); }

}  // extern "C"
